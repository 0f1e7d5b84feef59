"""End-to-end calibration from raw frames: the CameraCalibrator.calibrate
contract (camera_calibrator.ex:106-146): detect the checkerboard in each
frame, require >= 10 detections, run Zhang + LM, return the calibration
dict. The port's counterpart of ``send_slam_tpu/calib/pipeline.py``;
detection and refinement run on ``device`` (default the card)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from send_slam_tpu_torch.calib.checkerboard import detect_checkerboard
from send_slam_tpu_torch.calib.zhang import calibrate_camera, make_object_points
from send_slam_tpu_torch.device import resolve_device

MIN_SUCCESSFUL_FRAMES = 10   # camera_calibrator.ex:115


def calibrate(
    frames: List[np.ndarray],
    pattern_size: Tuple[int, int] = (9, 6),
    square_size: float = 25.0,
    min_frames: int = MIN_SUCCESSFUL_FRAMES,
    device=None,
) -> Dict:
    """frames: grayscale or RGB images. Raises ValueError if fewer than
    ``min_frames`` frames yield a full checkerboard detection."""
    dev = resolve_device(device)
    obj = make_object_points(pattern_size, square_size)
    obj_pts, img_pts = [], []
    for f in frames:
        if f.ndim == 3:
            f = (0.299 * f[..., 0] + 0.587 * f[..., 1]
                 + 0.114 * f[..., 2]).astype(np.float32)
        corners = detect_checkerboard(f, pattern_size, device=dev)
        if corners is not None:
            obj_pts.append(obj)
            img_pts.append(corners.astype(np.float64))
    if len(obj_pts) < min_frames:
        raise ValueError(
            f"insufficient_detections: {len(obj_pts)} < {min_frames}")
    return calibrate_camera(np.asarray(obj_pts), np.asarray(img_pts),
                            device=dev)
