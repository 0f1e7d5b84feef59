"""FAST-16 corner scores: the plain PyTorch version and the dispatcher.

``fast_score_map`` / ``nms3x3`` are the same dense formulation as the
JAX package's ``send_slam_tpu/ops/fast.py`` (16 shifted views, bit-mask
run test, arc-min score). They run on the CPU and are the oracle the
CUDA kernel (``csrc/fast_kernel.cu``) is held against on the card.

``fast_score_levels`` is what the front end calls, once per frame on
every pyramid level: a CUDA list goes to the kernel in one launch (or the
call raises), a CPU list to the plain version level by level
(``fast_score_levels_plain``). ``fast_score`` is the same for one image.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from send_slam_tpu_torch.ops.fast_cuda import fast_score_levels_cuda

# Bresenham circle radius 3, OpenCV pixel order (clockwise from top).
CIRCLE_OFFSETS: Tuple[Tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)  # (dx, dy)


def _pad2d(img: torch.Tensor, pad: int, mode: str, value: float = 0.0):
    """Pad the last two dims of (…, H, W)."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    if mode == "constant":
        x = F.pad(x, (pad, pad, pad, pad), mode="constant", value=value)
    else:
        x = F.pad(x, (pad, pad, pad, pad), mode=mode)
    return x.reshape(lead + x.shape[-2:])


def _has_run9(mask16: torch.Tensor) -> torch.Tensor:
    m = mask16 | (mask16 << 16)
    r2 = m & (m >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    r9 = r8 & (m >> 8)
    return (r9 & 0xFFFF) != 0


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-16 score map of (…, H, W) float32 intensities: the
    OpenCV-style corner score where the arc-9 test passes, else 0."""
    H, W = img.shape[-2], img.shape[-1]
    p = _pad2d(img, 3, "replicate")
    views = torch.stack([p[..., 3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W]
                         for dx, dy in CIRCLE_OFFSETS], -3)   # (…,16,H,W)
    d = views - img.unsqueeze(-3)
    weights = torch.tensor([1 << i for i in range(16)], dtype=torch.int32,
                           device=img.device).reshape(16, 1, 1)
    bright = ((d > threshold).to(torch.int32) * weights).sum(-3,
                                                            dtype=torch.int32)
    dark = ((d < -threshold).to(torch.int32) * weights).sum(-3,
                                                           dtype=torch.int32)
    is_corner = _has_run9(bright) | _has_run9(dark)

    def arc9_score(x):
        m = torch.minimum(x, torch.roll(x, -1, -3))
        m2 = torch.minimum(m, torch.roll(m, -2, -3))
        m4 = torch.minimum(m2, torch.roll(m2, -4, -3))
        m8 = torch.minimum(m4, torch.roll(x, -8, -3))
        return m8.amax(-3)

    score = torch.maximum(arc9_score(d), arc9_score(-d))
    return torch.where(is_corner, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep 3x3 local maxima of (…, H, W); ties go to the earlier pixel
    in raster order. Neighbours outside the image count as -inf."""
    H, W = score.shape[-2], score.shape[-1]
    p = _pad2d(score, 1, "constant", value=float("-inf"))
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n = p[..., 1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
            if dy < 0 or (dy == 0 and dx < 0):
                keep &= score >= n
            else:
                keep &= score > n
    return torch.where(keep, score, torch.zeros_like(score))


def fast_score(img: torch.Tensor, threshold: float, with_nms: bool = False):
    """FAST scores of one (H, W) or (B, H, W) float32 image: the raw map,
    or (raw, nms3x3(raw)) with ``with_nms`` (a one-level
    ``fast_score_levels``; the image is made contiguous first)."""
    return fast_score_levels([img.contiguous()], threshold, with_nms)[0]


def fast_score_levels(levels: Sequence[torch.Tensor], threshold: float,
                      with_nms: bool = False) -> List:
    """FAST scores of every pyramid level in ``levels`` (each (H, W), or
    each (B, H, W) with one B): a raw map per level, or a (raw,
    nms3x3(raw)) pair per level with ``with_nms``. A list of CUDA
    tensors is one kernel launch; a list of CPU tensors runs the plain
    version level by level."""
    levels = list(levels)
    if levels and all(lv.is_cuda for lv in levels):
        return fast_score_levels_cuda(levels, threshold, with_nms)
    if not all(lv.device.type == "cpu" for lv in levels):
        raise ValueError("fast_score_levels: levels must all lie on the "
                         "CPU or all on CUDA, got "
                         f"{sorted({str(lv.device) for lv in levels})}")
    return fast_score_levels_plain(levels, threshold, with_nms)


def fast_score_levels_plain(levels: Sequence[torch.Tensor], threshold: float,
                            with_nms: bool = False) -> List:
    """The plain PyTorch version of :func:`fast_score_levels`, level by
    level on any device (the kernel's reference on the card)."""
    out = []
    for lv in levels:
        raw = fast_score_map(lv, threshold)
        out.append((raw, nms3x3(raw)) if with_nms else raw)
    return out
