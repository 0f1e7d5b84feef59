"""Grayscale image pyramid + Gaussian blur.

Counterpart of ``send_slam_tpu/ops/pyramid.py`` with the same operation
order, so every level is bit-identical to the JAX package's eager
result: the 6:5 resample is static strided slices plus f32
multiply-adds, and the blur is shifted-slice weighted sums (not a
convolution, which cuDNN would run in TF32 on the card).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _is_six_fifths(scale: float) -> bool:
    return abs(scale - 1.2) < 1e-9


def level_shapes(height: int, width: int, n_levels: int,
                 scale: float) -> Tuple[Tuple[int, int], ...]:
    """Static (H, W) per level; exactly 5/6 per level at scale 1.2."""
    if _is_six_fifths(scale):
        out = [(height, width)]
        for _ in range(1, n_levels):
            h, w = out[-1]
            out.append((max((h // 6) * 5, 5), max((w // 6) * 5, 5)))
        return tuple(out)
    return tuple((int(round(height / scale ** i)), int(round(width / scale ** i)))
                 for i in range(n_levels))


def _gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  ksize: int = 7) -> torch.Tensor:
    """Separable Gaussian blur of (H, W) with reflect-101 borders."""
    k = _gaussian_kernel1d(sigma, ksize)
    pad = ksize // 2
    H, W = img.shape
    x = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    acc = None
    for i in range(ksize):
        term = float(k[i]) * x[:, i:i + W]
        acc = term if acc is None else acc + term
    out = None
    for i in range(ksize):
        term = float(k[i]) * acc[i:i + H, :]
        out = term if out is None else out + term
    return out


# Half-pixel bilinear 6:5: output row 5q + r samples input 6q + offset
# with weight w on the next row.
_PHASE = ((0, 0.1), (1, 0.3), (2, 0.5), (3, 0.7), (4, 0.9))


def _down65_rows(x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape
    q = H // 6
    g = x[: q * 6].reshape(q, 6, W)
    outs = [(1.0 - w) * g[:, o, :] + w * g[:, o + 1, :] for (o, w) in _PHASE]
    return torch.stack(outs, 1).reshape(q * 5, W)


def _down65_cols(x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape
    q = W // 6
    g = x[:, : q * 6].reshape(H, q, 6)
    outs = [(1.0 - w) * g[:, :, o] + w * g[:, :, o + 1] for (o, w) in _PHASE]
    return torch.stack(outs, 2).reshape(H, q * 5)


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale: float) -> List[torch.Tensor]:
    """(H, W) float32 -> n_levels images. Only the exact 6:5 scale is
    supported (the configuration every path of the engine uses)."""
    if not _is_six_fifths(scale):
        raise NotImplementedError(
            "send_slam_tpu_torch builds the pyramid at scale 1.2 only")
    shapes = level_shapes(img.shape[0], img.shape[1], n_levels, scale)
    levels = [img]
    for i in range(1, n_levels):
        nxt = _down65_cols(_down65_rows(levels[-1]))
        assert tuple(nxt.shape) == shapes[i], (nxt.shape, shapes[i])
        levels.append(nxt)
    return levels
