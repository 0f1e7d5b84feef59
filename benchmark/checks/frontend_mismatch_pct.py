"""``frontend_mismatch_pct``: of the keypoints the reference finds on the
sampled frames, the share (%) whose validity, level-0 position, octave,
score, descriptor, angle (1e-4 rad) or undistorted position (1e-3 px)
the program's Frame does not give.

Stage ``frontend``: each image ``make_frames`` turned into a Frame (the
System's ``make_frame`` calls it).

Control: the front end runs no matrix product; its stages that a later
change would be tempted to hand to cuDNN (the pyramid's resample and the
blur, both convolutions) are put in the program's place computed as
TF32 computes them: each operand of their multiply-adds rounded to 10
mantissa bits.
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
MANTISSA_TF32 = 10


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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32's mantissa, to nearest even."""
    drop = 23 - MANTISSA_TF32
    b = x.contiguous().view(torch.int32)
    b = (b + ((1 << (drop - 1)) - 1) + ((b >> drop) & 1)) & ~((1 << drop) - 1)
    return b.view(torch.float32)


def _mul(w: float, x: torch.Tensor) -> torch.Tensor:
    wt = round_tf32(torch.tensor([w], dtype=torch.float32))[0].item()
    return wt * round_tf32(x)


def _down65(x: torch.Tensor, axis: int) -> torch.Tensor:
    from send_slam_tpu_torch.ops.pyramid import _PHASE
    x = x.movedim(axis, 0)
    q = x.shape[0] // 6
    g = x[: q * 6].reshape((q, 6) + tuple(x.shape[1:]))
    outs = [_mul(1.0 - w, g[:, o]) + _mul(w, g[:, o + 1]) for o, w in _PHASE]
    return torch.stack(outs, 1).reshape((q * 5,) + tuple(x.shape[1:])) \
        .movedim(0, axis)


def build_pyramid_tf32(img, n_levels, scale):
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(_down65(_down65(levels[-1], 0), 1))
    return levels


def gaussian_blur_tf32(img, sigma=2.0, ksize=7):
    from send_slam_tpu_torch.ops.pyramid import _gaussian_kernel1d
    k = _gaussian_kernel1d(sigma, ksize)
    pad = ksize // 2
    H, W = img.shape
    x = torch.nn.functional.pad(img[None, None], (pad,) * 4,
                                mode="reflect")[0, 0]
    acc = sum(_mul(float(k[i]), x[:, i:i + W]) for i in range(ksize))
    return sum(_mul(float(k[i]), acc[i:i + H, :]) for i in range(ksize))


def CONTROL(patch) -> None:
    """The pyramid and the blur in TF32, where ``orb`` looks them up."""
    from send_slam_tpu_torch.ops import orb
    patch(orb, "build_pyramid", build_pyramid_tf32)
    patch(orb, "gaussian_blur", gaussian_blur_tf32)
