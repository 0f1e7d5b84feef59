"""Per-frame feature bundle: ORB features + undistorted keypoints.

Counterpart of ``send_slam_tpu/models/frame.py``: keypoints are
undistorted once here, so everything downstream projects with a pure
pinhole model.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from send_slam_tpu_torch.config import CameraConfig, OrbConfig
from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.geometry.camera import (
    undistort_points, undistort_points_kb8,
)
from send_slam_tpu_torch.ops.orb import FrameFeatures, extract_orb_batch


class Frame(NamedTuple):
    feat: FrameFeatures
    uv_und: torch.Tensor     # (N, 2) float32 undistorted pixel coords
    timestamp: torch.Tensor  # () float32


def make_frame(img, timestamp, orb_cfg: OrbConfig, cam: CameraConfig,
               device=None) -> Frame:
    """(H, W) grayscale (numpy or tensor, any real dtype) -> Frame on
    ``device`` (default the card): ``make_frames`` of a batch of one."""
    return make_frames(img[None], [float(timestamp)], orb_cfg, cam,
                       device)[0]


def make_frames(imgs, timestamps, orb_cfg: OrbConfig, cam: CameraConfig,
                device=None) -> List[Frame]:
    """(B, H, W) grayscale images and (B,) timestamps -> one Frame per
    image on ``device`` (default the card), each the same bits whatever
    the batch; FAST runs once for the whole batch (one kernel launch on
    the card over every level of every image)."""
    dev = resolve_device(device)
    imgs = torch.as_tensor(imgs).to(device=dev, dtype=torch.float32)
    ts = torch.as_tensor(timestamps, dtype=torch.float32).reshape(-1)
    return [_frame(feat, float(t), cam)
            for feat, t in zip(extract_orb_batch(imgs, orb_cfg), ts)]


def _frame(feat, timestamp, cam: CameraConfig) -> Frame:
    """Undistort the keypoints of ``feat`` and bundle the Frame."""
    dev = feat.uv.device
    has_dist = any(abs(v) > 0 for v in (cam.k1, cam.k2, cam.p1, cam.p2,
                                        cam.k3))
    if cam.model == "KannalaBrandt8":
        dist = torch.tensor([cam.k1, cam.k2, cam.p1, cam.p2],
                            dtype=torch.float32, device=dev)
        uv_und = undistort_points_kb8(feat.uv, cam.fx, cam.fy, cam.cx,
                                      cam.cy, dist)
    elif has_dist:
        dist = torch.tensor([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3],
                            dtype=torch.float32, device=dev)
        uv_und = undistort_points(feat.uv, cam.fx, cam.fy, cam.cx, cam.cy,
                                  dist)
    else:
        uv_und = feat.uv
    return Frame(feat=feat, uv_und=uv_und,
                 timestamp=torch.tensor(float(timestamp), dtype=torch.float32,
                                        device=dev))
