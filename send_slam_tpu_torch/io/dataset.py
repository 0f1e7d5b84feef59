"""Dataset loaders and ground truth for offline evaluation.

The port's counterpart of ``send_slam_tpu/io/dataset.py``, with the same
API, parsing and constants: TUM RGB-D monocular sequences (``rgb.txt``
index and ``groundtruth.txt``) and EuRoC MAV (``mav0/cam0/data.csv`` and
the state estimate csv). Frames are read as 8-bit gray by the port's own
PNG reader (``io/png.py``), which returns what the reference's
``cv2.imread(path, IMREAD_GRAYSCALE)`` returns; a frame it returns None
for is skipped, as the reference skips cv2's None. Loaders raise
FileNotFoundError when a layout is absent.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from send_slam_tpu_torch.io.png import read_png


def _rows(path: str, sep: Optional[str] = None) -> Iterator[List[str]]:
    """The fields of each line that is neither empty nor a comment."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split(sep)


def _gray_frames(frames) -> Iterator[Tuple[float, np.ndarray]]:
    for ts, path in frames:
        img = read_png(path, gray=True)
        if img is not None:
            yield ts, img


class TumSequence:
    """TUM RGB-D layout: rgb.txt lists "timestamp rgb/<file>.png";
    groundtruth.txt lists "timestamp tx ty tz qx qy qz qw"."""

    # fr1 intrinsics (the standard calibrated values).
    FR1_INTRINSICS = dict(fx=517.306408, fy=516.469215,
                          cx=318.643040, cy=255.313989,
                          k1=0.262383, k2=-0.953104, p1=-0.005358,
                          p2=0.002628, k3=1.163314)

    def __init__(self, root: str):
        self.root = root
        rgb_txt = os.path.join(root, "rgb.txt")
        if not os.path.exists(rgb_txt):
            raise FileNotFoundError(rgb_txt)
        self.frames: List[Tuple[float, str]] = [
            (float(v[0]), os.path.join(root, v[1])) for v in _rows(rgb_txt)]
        self.groundtruth = self._load_gt(os.path.join(root, "groundtruth.txt"))

    @staticmethod
    def _load_gt(path: str) -> Optional[np.ndarray]:
        if not os.path.exists(path):
            return None
        # (N, 8): ts tx ty tz qx qy qz qw
        return np.asarray([[float(x) for x in v[:8]] for v in _rows(path)])

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        return _gray_frames(self.frames)

    def gt_positions(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.groundtruth is None:
            raise ValueError("no groundtruth.txt")
        return self.groundtruth[:, 0], self.groundtruth[:, 1:4]


class EurocSequence:
    """EuRoC MAV layout: mav0/cam0/data/<ns>.png with data.csv index;
    ground truth in mav0/state_groundtruth_estimate0/data.csv."""

    CAM0_INTRINSICS = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                           k1=-0.28340811, k2=0.07395907,
                           p1=0.00019359, p2=1.76187114e-05, k3=0.0)

    def __init__(self, root: str):
        self.root = root
        cam_csv = os.path.join(root, "mav0", "cam0", "data.csv")
        if not os.path.exists(cam_csv):
            raise FileNotFoundError(cam_csv)
        data = os.path.join(root, "mav0", "cam0", "data")
        # ns -> s as the reference converts it: int(ns) * 1e-9.
        self.frames = [(int(v[0]) * 1e-9, os.path.join(data, v[1].strip()))
                       for v in _rows(cam_csv, ",")]
        gt_csv = os.path.join(root, "mav0",
                              "state_groundtruth_estimate0", "data.csv")
        self.groundtruth = None
        if os.path.exists(gt_csv):
            self.groundtruth = np.asarray(
                [[int(v[0]) * 1e-9] + [float(x) for x in v[1:4]]
                 for v in _rows(gt_csv, ",")])

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        return _gray_frames(self.frames)

    def gt_positions(self):
        if self.groundtruth is None:
            raise ValueError("no ground truth")
        return self.groundtruth[:, 0], self.groundtruth[:, 1:4]


def open_sequence(root: str):
    """Auto-detect dataset flavour."""
    if os.path.exists(os.path.join(root, "rgb.txt")):
        return TumSequence(root)
    if os.path.exists(os.path.join(root, "mav0")):
        return EurocSequence(root)
    raise FileNotFoundError(f"no known dataset layout at {root}")
