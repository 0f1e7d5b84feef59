"""``frontend_mismatch_pct``: of the keypoints the reference finds on the
sampled frames, the share (%) whose validity, level-0 position, octave,
score, descriptor, angle (1e-4 rad) or undistorted position (1e-3 px)
the program's Frame does not give.

Stage ``frontend``: each image ``make_frames`` turned into a Frame (the
System's ``make_frame`` calls it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from harness.correct import to_np, words
from reference import frontend as ref_frontend

STAGE = "frontend"
SAMPLE = 3
SITES = [("send_slam_tpu_torch.models.frame", "make_frames")]


def keep(args, kwargs, frames):
    imgs = args[0]
    if isinstance(imgs, torch.Tensor):
        imgs = imgs.numpy()
    return [(np.asarray(imgs[i]), f) for i, f in enumerate(frames)]


def mismatch_pct(items, orb: Dict, cam: Dict) -> Optional[float]:
    bad = total = 0
    for img, frame in items:
        ref = ref_frontend.frame_features(img, orb, cam)
        f = frame.feat
        valid = to_np(f.valid)
        either = valid | ref["valid"]
        ang = np.abs(np.angle(np.exp(1j * (to_np(f.angle).astype(np.float64)
                                          - ref["angle"]))))
        differs = ((valid != ref["valid"])
                   | (np.abs(to_np(f.uv) - ref["uv"]).max(1) > 1e-4)
                   | (to_np(f.octave) != ref["octave"])
                   | (to_np(f.response) != ref["response"])
                   | (words(f.desc) != ref["desc"]).any(1)
                   | (ang > 1e-4)
                   | (np.abs(to_np(frame.uv_und) - ref["uv_und"]).max(1)
                      > 1e-3))
        bad += int((differs & either).sum())
        total += int(either.sum())
    return None if total == 0 else 100.0 * bad / total


def value(items, config: Dict) -> Optional[float]:
    engine = config["engine"]
    return mismatch_pct(items, engine["orb"], engine["camera"])


def info(items) -> Dict:
    """The sampled frames' fill, for the result's ``info``."""
    return dict(keypoints_per_frame=(
        sum(int(f.feat.valid.sum()) for _, f in items) / len(items)
        if items else None))
