"""Grayscale image pyramid + Gaussian blur.

Counterpart of ``send_slam_tpu/ops/pyramid.py`` with the same operation
order, so every level is bit-identical to the JAX package's eager
result: the 6:5 resample is static strided slices plus f32
multiply-adds, and the blur is shifted-slice weighted sums (not a
convolution, which cuDNN would run in TF32 on the card).

At any other scale the JAX package resamples each level from the one
before with ``jax.image.resize(prev, shape, method="linear")``, whose
``antialias=True`` widens the triangle kernel by the scale when it
shrinks. Here the same per-axis (in, out) weight matrices
(``jax/_src/image/scale.py`` ``compute_weight_mat``) are built in f32
and applied as two matmuls (TF32 is off in the port): within the
rounding of the reference's own fused weights, not bit for bit
(tests/test_torch_pyramid.py).
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


def resize_weights(m: int, n: int, device) -> torch.Tensor:
    """(m, n) f32 weights taking m samples to n along one axis, as
    ``jax.image.resize(..., method="linear")`` builds them: half-pixel
    sample positions, the triangle kernel widened by m / n when n < m
    (antialias), columns normalised to sum 1 and zeroed where the sample
    falls outside the input."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one multiply-add with a
    # single rounding; the f32 product is exact in f64, so computing in
    # f64 and rounding once gives the same positions.
    inv32 = float(np.float32(inv_scale))
    sample_f = ((torch.arange(n, **f32) + 0.5).double() * inv32
                - 0.5).float()
    x = torch.abs(sample_f[None, :] - torch.arange(m, **f32)[:, None]) \
        / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, 0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """(H, W) -> ``shape``: ``jax.image.resize(x, shape, "linear")``."""
    H, W = x.shape
    h, w = shape
    if h != H:
        x = resize_weights(H, h, x.device).T @ x
    if w != W:
        x = x @ resize_weights(W, w, x.device)
    return x


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale: float) -> List[torch.Tensor]:
    """(H, W) float32 -> n_levels images, each ~1/scale smaller: the
    exact 6:5 strided resample at scale 1.2, ``resize_linear`` from the
    previous level at any other scale."""
    shapes = level_shapes(img.shape[0], img.shape[1], n_levels, scale)
    levels = [img]
    for i in range(1, n_levels):
        if _is_six_fifths(scale):
            nxt = _down65_cols(_down65_rows(levels[-1]))
            assert tuple(nxt.shape) == shapes[i], (nxt.shape, shapes[i])
        else:
            nxt = resize_linear(levels[-1], shapes[i])
        levels.append(nxt)
    return levels
