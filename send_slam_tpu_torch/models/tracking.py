"""Per-frame tracking: projection-guided matching + pose-only robust
Gauss-Newton.

Counterpart of ``send_slam_tpu/models/tracking.py``: two passes of
search-by-projection (wide window at the motion-model prediction, tight
window at the refined pose) with Huber GN rounds between them, chi2
outlier reclassification, the ORB-SLAM isInFrustum gates (viewing
angle, distance band, predicted octave) and the in-graph rescue pass.
The JAX package's ``lax.cond`` on the rescue becomes a Python branch,
and its ``lax.scan`` of Gauss-Newton steps, on the card, one launch of
csrc/pose_gn_kernel.cu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from send_slam_tpu_torch.config import TrackingConfig
from send_slam_tpu_torch.geometry.se3 import se3_compose, se3_exp
from send_slam_tpu_torch.ops.hamming import (
    Matches, match_descriptors, projection_window_mask,
)
from send_slam_tpu_torch.ops.pose_gn_cuda import pose_gn_cuda
from send_slam_tpu_torch.utils.profiling import count

CHI2_2DOF = 5.991


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier: torch.Tensor
    chi2: torch.Tensor
    n_inliers: torch.Tensor


def _project_and_jacobian(R, t, X, fx, fy, cx, cy):
    """Project world points (N,3); Jacobian wrt a left increment
    exp(delta) T, delta = (rho, phi). Returns (uv, p_cam, J (N,2,6))."""
    p = X @ R.T + t[None]
    z = torch.clamp(p[:, 2], min=1e-6)
    inv_z = 1.0 / z
    u = fx * p[:, 0] * inv_z + cx
    v = fy * p[:, 1] * inv_z + cy
    uv = torch.stack([u, v], -1)
    zeros = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * p[:, 0] * inv_z * inv_z], -1),
        torch.stack([zeros, fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], -1),
    ], -2)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    neg_hat = torch.stack([
        torch.stack([zeros, pz, -py], -1),
        torch.stack([-pz, zeros, px], -1),
        torch.stack([py, -px, zeros], -1),
    ], -2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand_as(neg_hat)
    J = J_proj @ torch.cat([eye, neg_hat], -1)
    return uv, p, J


def pose_only_gn(R0, t0, X, uv_obs, w_valid, fx, fy, cx, cy, sigma2=None,
                 rounds: int = 4, iters: int = 10,
                 huber_delta: float = 2.447) -> PoseOptResult:
    """Robust pose-only Gauss-Newton: ``rounds`` x ``iters`` Huber
    steps with chi2 inlier reclassification after each round. CUDA
    tensors take one launch of the CUDA kernel (``ops/pose_gn_cuda.py``,
    csrc/pose_gn_kernel.cu); CPU tensors :func:`pose_only_gn_plain`."""
    if X.is_cuda:
        return PoseOptResult(*pose_gn_cuda(
            R0, t0, X, uv_obs, w_valid, fx, fy, cx, cy, sigma2=sigma2,
            rounds=rounds, iters=iters, huber_delta=huber_delta))
    return pose_only_gn_plain(R0, t0, X, uv_obs, w_valid, fx, fy, cx, cy,
                              sigma2=sigma2, rounds=rounds, iters=iters,
                              huber_delta=huber_delta)


def pose_only_gn_plain(R0, t0, X, uv_obs, w_valid, fx, fy, cx, cy,
                       sigma2=None, rounds: int = 4, iters: int = 10,
                       huber_delta: float = 2.447) -> PoseOptResult:
    """The plain PyTorch version of :func:`pose_only_gn`, op by op on any
    device (the kernel's reference on the card)."""
    if sigma2 is None:
        sigma2 = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    inv_sigma2 = 1.0 / sigma2
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t, inlier = R0, t0, w_valid
    for _ in range(rounds):
        for _ in range(iters):
            uv, p, J = _project_and_jacobian(R, t, X, fx, fy, cx, cy)
            r = uv - uv_obs
            chi2 = (r * r).sum(-1) * inv_sigma2
            nrm = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_huber = torch.clamp(huber_delta / nrm, max=1.0)
            w = (w_valid & inlier & (p[:, 2] > 1e-3)).to(X.dtype) \
                * w_huber * inv_sigma2
            H = torch.einsum('nia,n,nib->ab', J, w, J) + 1e-6 * eye6
            b = torch.einsum('nia,n,ni->a', J, w, r)
            delta = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
            dR, dt = se3_exp(delta)
            R, t = se3_compose(dR, dt, R, t)
        uv, p, _ = _project_and_jacobian(R, t, X, fx, fy, cx, cy)
        chi2 = ((uv - uv_obs) ** 2).sum(-1) * inv_sigma2
        inlier = w_valid & (chi2 < CHI2_2DOF) & (p[:, 2] > 1e-3)
    uv, p, _ = _project_and_jacobian(R, t, X, fx, fy, cx, cy)
    chi2_all = ((uv - uv_obs) ** 2).sum(-1) * inv_sigma2
    chi2 = torch.where(inlier, torch.clamp(chi2_all, max=CHI2_2DOF),
                       torch.zeros_like(chi2_all)).sum()
    return PoseOptResult(R=R, t=t, inlier=inlier, chi2=chi2,
                         n_inliers=inlier.sum(dtype=torch.int32))


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    matches: Matches        # landmark-row -> keypoint-column matches
    inlier: torch.Tensor    # (L,) bool over landmark rows
    in_view: torch.Tensor   # (L,) bool
    n_inliers: torch.Tensor  # () int32


def track_frame(R_pred, t_pred, lm_pos, lm_desc, lm_valid, kp_uv, kp_desc,
                kp_valid, kp_octave, fx, fy, cx, cy, width: int, height: int,
                cfg: TrackingConfig, scale_factor: float = 1.2,
                search_radius: float = None, R_rescue=None, t_rescue=None,
                enable_rescue: bool = True, lm_normal=None, lm_dist_min=None,
                lm_dist_max=None, n_levels: int = 8) -> TrackResult:
    """One tracking step: two-pass search-by-projection + robust pose GN,
    with a very wide rescue pass when the track starves."""
    radius = cfg.search_radius_px if search_radius is None else search_radius
    gated = lm_normal is not None and lm_dist_max is not None
    L = lm_pos.shape[0]
    dev = lm_pos.device

    def project(R, t):
        p = lm_pos @ R.T + t[None]
        z = p[:, 2]
        zc = torch.clamp(z, min=1e-6)
        uv = torch.stack([fx * p[:, 0] / zc + cx, fy * p[:, 1] / zc + cy], -1)
        in_view = (lm_valid & (z > 0.01) & (uv[:, 0] >= 0)
                   & (uv[:, 0] < width) & (uv[:, 1] >= 0)
                   & (uv[:, 1] < height))
        if not gated:
            return uv, in_view, torch.zeros(L, dtype=torch.int32, device=dev), \
                torch.zeros(L, dtype=torch.bool, device=dev)
        C = -(R.T @ t[:, None])[:, 0]
        d = lm_pos - C[None]
        dist = torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-6)
        view_cos = (d * lm_normal).sum(-1) / dist
        has = lm_dist_max > 0
        floor_ratio = scale_factor ** max(n_levels - 1,
                                          cfg.lm_band_floor_octaves)
        g = torch.sqrt(torch.clamp(lm_dist_min, min=1e-9)
                       * torch.clamp(lm_dist_max, min=1e-9))
        half = float(floor_ratio) ** 0.5
        dmin_eff = torch.minimum(lm_dist_min, g / half)
        dmax_eff = torch.maximum(lm_dist_max, g * half)
        ok = (view_cos > 0.5) & (dist >= 0.8 * dmin_eff) \
            & (dist <= 1.3 * dmax_eff)
        in_view = in_view & (ok | ~has)
        ratio = torch.clamp(lm_dist_max, min=1e-6) / dist
        lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6)) / log_s)
        lvl = torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)
        return uv, in_view, lvl, has

    sigma2 = (scale_factor ** kp_octave.to(torch.float32)) ** 2
    # log in f32 of f32(scale_factor), as jnp.log(scale_factor) takes it.
    log_s = torch.log(torch.tensor(scale_factor, dtype=torch.float32,
                                   device=dev))

    def match_and_optimize(R, t, rad, gn_rounds):
        uv_pred, in_view, lvl, has = project(R, t)
        rad_row = rad * torch.where(
            has, scale_factor ** lvl.to(torch.float32),
            torch.ones((), device=dev))
        window = projection_window_mask(
            uv_pred, kp_uv, rad_row, octave_pred=lvl, octave_kp=kp_octave,
            octave_slack=cfg.octave_slack, octave_gate=has)
        m, mc = match_descriptors(lm_desc, kp_desc, in_view, kp_valid,
                                  max_dist=float(cfg.hamming_th_high),
                                  ratio=1e9, mutual=True,
                                  extra_mask=window, return_col=True)
        X_col = lm_pos[torch.clamp(mc.idx, 0, L - 1)]
        opt = pose_only_gn(R, t, X_col, kp_uv, mc.valid, fx, fy, cx, cy,
                           sigma2=sigma2, huber_delta=cfg.huber_delta,
                           iters=cfg.pose_gn_inner, rounds=gn_rounds)
        # Per-keypoint verdicts back onto landmark rows.
        kp_inl = opt.inlier[torch.clamp(m.idx, 0, kp_uv.shape[0] - 1)]
        inl_rows = m.valid & kp_inl & (m.idx >= 0)
        return m, opt._replace(inlier=inl_rows), in_view

    _, opt1, _ = match_and_optimize(R_pred, t_pred, radius, 2)
    m, opt, in_view = match_and_optimize(opt1.R, opt1.t, min(radius, 9.0), 4)

    if enable_rescue:
        count("sync.track_inliers")
    if enable_rescue and int(opt.n_inliers) < cfg.min_track_matches:
        Rb = R_pred if R_rescue is None else R_rescue
        tb = t_pred if t_rescue is None else t_rescue
        full = float(max(width, height))
        _, o1, _ = match_and_optimize(Rb, tb, full, 2)
        m, opt, in_view = match_and_optimize(o1.R, o1.t, 9.0, 4)

    return TrackResult(R=opt.R, t=opt.t, matches=m, inlier=opt.inlier,
                       in_view=in_view, n_inliers=opt.n_inliers)
