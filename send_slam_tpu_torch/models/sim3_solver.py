"""Sim(3) estimation between matched 3-D point sets.

Counterpart of ``send_slam_tpu/models/sim3_solver.py``: minimal 3-point
Umeyama hypotheses solved for every RANSAC lane at once (a leading
batch dim for the JAX package's ``vmap``), the hypothesis with the most
inliers refit twice on its consensus set.

The random draw is a parameter: ``noise`` (n_hyp, N) Gumbel values, of
which each hypothesis takes the top 3 over the valid pairs. The JAX
package draws them with ``jax.random.gumbel``; a test passes those
draws, the System draws them with ``gumbel_noise`` from its CPU
generator.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from send_slam_tpu_torch.ops.orb import stable_topk


class Sim3Result(NamedTuple):
    ok: torch.Tensor          # () bool
    s: torch.Tensor           # () scale
    R: torch.Tensor           # (3,3)
    t: torch.Tensor           # (3,)
    inlier: torch.Tensor      # (N,) bool
    n_inliers: torch.Tensor   # () int64


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws of ``shape`` from ``generator`` on its own
    device, moved to ``device`` (a CPU generator gives a run on the card
    the draws of the same run on the CPU)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def umeyama_sim3(src, dst, w=None):
    """Weighted closed-form similarity dst ~ s R src + t, batched over
    leading dims. src, dst: (..., N, 3); w: (..., N) weights (0 masks a
    row). Returns (s (...), R (..., 3, 3), t (..., 3))."""
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    mu_s = (src * w[..., None]).sum(-2) / wsum
    mu_d = (dst * w[..., None]).sum(-2) / wsum
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = (xd * w[..., None]).transpose(-1, -2) @ xs / wsum[..., None]
    U, D, Vt = torch.linalg.svd(cov)
    # The sign may be 0 (a degenerate cloud), as in the reference.
    sgn = torch.sign(torch.linalg.det(U @ Vt))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1)
    R = U @ (diag[..., :, None] * Vt)
    var_s = (w[..., None] * xs * xs).sum((-1, -2)) / wsum[..., 0]
    s = (D * diag).sum(-1) / torch.clamp(var_s, min=1e-12)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def _inliers(s, R, t, src, dst, valid, th):
    pred = s[..., None, None] * (src @ R.transpose(-1, -2)) + t[..., None, :]
    return (torch.linalg.norm(pred - dst, dim=-1) < th) & valid


def sim3_ransac(src, dst, valid, noise, inlier_th: float = 0.05,
                min_inliers: int = 8) -> Sim3Result:
    """RANSAC Sim(3): src/dst (N,3) matched points, valid (N,) mask,
    noise (n_hyp, N) Gumbel draws.

    ``inlier_th`` is relative: a pair is an inlier when its aligned
    residual is below inlier_th x the robust scene scale, so the gate is
    invariant to the monocular gauge."""
    vf = valid[:, None]
    mean = torch.where(vf, dst, torch.zeros_like(dst)).mean(0, keepdim=True)
    scene = torch.sqrt(torch.where(vf, (dst - mean) ** 2,
                                   torch.zeros_like(dst)).sum()
                       / torch.clamp(valid.sum(), min=1))
    th = inlier_th * torch.clamp(scene, min=1e-6)

    g = torch.where(valid[None, :], noise, torch.full_like(noise, -math.inf))
    idx = stable_topk(g, 3)[1]                                 # (n_hyp, 3)
    ss, Rs, ts = umeyama_sim3(src[idx], dst[idx])
    inls = _inliers(ss, Rs, ts, src, dst, valid, th)           # (n_hyp, N)
    best = torch.argmax(inls.sum(-1))       # the first of equal counts

    w = inls[best].to(src.dtype)
    s, R, t = umeyama_sim3(src, dst, w)
    inl = _inliers(s, R, t, src, dst, valid, th)
    s, R, t = umeyama_sim3(src, dst, inl.to(src.dtype))
    inl = _inliers(s, R, t, src, dst, valid, th)
    n = inl.sum()
    return Sim3Result(ok=n >= min_inliers, s=s, R=R, t=t, inlier=inl,
                      n_inliers=n)
