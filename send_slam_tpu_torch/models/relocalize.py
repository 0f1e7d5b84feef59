"""Relocalization: global descriptor matching + batched PnP RANSAC.

Counterpart of ``send_slam_tpu/models/relocalize.py``: with tracking
lost, the frame's descriptors are matched against the landmark table
without a pose prior, a linear 6-point DLT PnP is solved for every
RANSAC hypothesis at once (a leading batch dim for the JAX package's
``vmap``), the hypothesis with the most reprojection inliers is refined
by the robust pose-only Gauss-Newton of ``models/tracking.py``.

The minimal sets are a parameter (``sample_idx``): by default they are
drawn by Gumbel-top-k from ``generator``; a test passes the JAX
package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from send_slam_tpu_torch.config import TrackingConfig
from send_slam_tpu_torch.geometry.epipolar import _smallest_singular_vector
from send_slam_tpu_torch.models.initializer import sample_minimal_sets
from send_slam_tpu_torch.models.tracking import pose_only_gn
from send_slam_tpu_torch.ops.hamming import Matches, match_descriptors

CHI2_2DOF = 5.991


class RelocResult(NamedTuple):
    ok: torch.Tensor          # () bool
    R: torch.Tensor           # (3,3) camera-from-world
    t: torch.Tensor           # (3,)
    n_inliers: torch.Tensor   # () int32


def _pnp_dlt(X: torch.Tensor, xn: torch.Tensor):
    """Linear PnP from >= 6 points: X (..., K, 3) world, xn (..., K, 2)
    normalized image coords. Returns (R (..., 3, 3) orthonormalized,
    t (..., 3)) in the inputs' dtype.

    Solved in float64: the unnormalized DLT's null vector is
    ill-conditioned in float32 (the JAX package's float32 solve strays up
    to ~4e-3 from the exact pose on exact six-point draws); float64 keeps
    the port within 1e-5 of it, at no cost that matters for 12x12
    systems."""
    dtype = X.dtype
    X, xn = X.to(torch.float64), xn.to(torch.float64)
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], -1)                               # (..., K, 4)
    r1 = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], -1)         # (..., K, 12)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], -2)                                 # (..., 2K, 12)
    p = _smallest_singular_vector(A).reshape(X.shape[:-2] + (3, 4))
    # Scale: rotation rows of unit norm; sign: points in front.
    det = torch.linalg.det(p[..., :3])
    scale = torch.pow(det.abs(), 1.0 / 3.0)
    scale = torch.where(scale < 1e-12, torch.ones_like(scale), scale)
    p = p / scale[..., None, None]
    z = (X @ p[..., :3].transpose(-1, -2) + p[..., None, :, 3])[..., 2]
    sign = torch.sign(z.sum(-1))
    p = p * torch.where(sign == 0, torch.ones_like(sign), sign)[..., None,
                                                                 None]
    U, _, Vt = torch.linalg.svd(p[..., :3])
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    return R.to(dtype), p[..., 3].to(dtype)


def reloc_matches(lm_desc, kp_desc, lm_valid, kp_valid,
                  cfg: TrackingConfig) -> Matches:
    """Prior-free landmark -> keypoint matches (ratio 0.9, mutual)."""
    return match_descriptors(lm_desc, kp_desc, lm_valid, kp_valid,
                             max_dist=float(cfg.hamming_th_low), ratio=0.9,
                             mutual=True)


def relocalize(lm_pos, lm_desc, lm_valid, kp_uv, kp_desc, kp_valid, K,
               cfg: TrackingConfig, n_hyp: int = 256, min_inliers: int = 15,
               generator: torch.Generator = None,
               sample_idx: torch.Tensor = None) -> RelocResult:
    """Pose recovery without a prior. ``sample_idx`` (n_hyp, 6) landmark
    rows, else drawn over the valid matches from ``generator``."""
    m = reloc_matches(lm_desc, kp_desc, lm_valid, kp_valid, cfg)
    uv = kp_uv[torch.clamp(m.idx, 0, kp_uv.shape[0] - 1).long()]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)

    if sample_idx is None:
        sample_idx = sample_minimal_sets(generator, m.valid, n_hyp, 6)
    idx = sample_idx.to(device=lm_pos.device, dtype=torch.int64)
    Rs, ts = _pnp_dlt(lm_pos[idx], xn[idx])                    # (n_hyp, ...)

    p = torch.einsum('nj,hij->hni', lm_pos, Rs) + ts[:, None, :]
    z = torch.clamp(p[..., 2], min=1e-6)
    u = fx * p[..., 0] / z + cx
    v = fy * p[..., 1] / z + cy
    err = ((torch.stack([u, v], -1) - uv[None]) ** 2).sum(-1)
    scores = ((err < CHI2_2DOF) & m.valid[None] & (p[..., 2] > 0)).sum(-1)
    best = torch.argmax(scores)

    opt = pose_only_gn(Rs[best], ts[best], lm_pos, uv, m.valid, fx, fy, cx,
                       cy, huber_delta=cfg.huber_delta)
    return RelocResult(ok=opt.n_inliers >= min_inliers, R=opt.R, t=opt.t,
                       n_inliers=opt.n_inliers)
