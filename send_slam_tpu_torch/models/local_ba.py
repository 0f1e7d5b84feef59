"""Local bundle adjustment: sparse Gauss-Newton with Schur-complement
landmark elimination.

Counterpart of ``send_slam_tpu/models/local_ba.py``
``local_bundle_adjustment`` through ``_ba_small``: the window's dense
(W, N) keypoint -> landmark table is the observation set, landmark 3x3
blocks are eliminated in closed form over the whole landmark table, the
reduced (6W)^2 camera system is solved dense, and each Levenberg step is
accepted only if the robust cost does not increase; an observation prune
follows. Assembly is an order-fixed segment sum and a row gather
(``ops/segsum.ObsMap``). ``wide_bundle_adjustment``,
``global_bundle_adjustment`` and ``ba_slice`` are the JAX package's thin
wrappers over it.

The JAX package assembles windows wider than ``kf_chunk`` keyframes (the
global window, every keyframe slot) by a ``lax.scan`` over keyframe
chunks (``_ba_chunked``), only to bound the TPU's (ML, kf_chunk * N)
observation one-hot. The port builds no one-hot, so every window is
assembled in one block and solves the same joint problem.
"""

from __future__ import annotations

import dataclasses

import torch

from send_slam_tpu_torch.config import MapConfig
from send_slam_tpu_torch.geometry.se3 import se3_compose, se3_exp
from send_slam_tpu_torch.models.map_state import MapState, set_rows
from send_slam_tpu_torch.ops.segsum import ObsMap

CHI2_2DOF = 5.991


def _project_planes(kf_R, kf_t, x, y, zw):
    def Rc(i, j):
        return kf_R[:, i, j][:, None]

    px = Rc(0, 0) * x + Rc(0, 1) * y + Rc(0, 2) * zw + kf_t[:, 0:1]
    py = Rc(1, 0) * x + Rc(1, 1) * y + Rc(1, 2) * zw + kf_t[:, 1:2]
    pz = Rc(2, 0) * x + Rc(2, 1) * y + Rc(2, 2) * zw + kf_t[:, 2:3]
    return px, py, pz


def _obs_terms(kf_R, kf_t, kf_uv, inv_sigma2, obs_valid, x, y, zw,
               fx, fy, cx, cy, huber_delta):
    """Residuals, Huber weights and Jacobian planes of a (W, N) window.
    Returns (ru, rv, wgt, Jp_u, Jp_v (W,6,N), Jt_u, Jt_v (W,3,N), pz)."""
    px, py, pz = _project_planes(kf_R, kf_t, x, y, zw)
    z = torch.clamp(pz, min=1e-6)
    inv_z = 1.0 / z
    ru = fx * px * inv_z + cx - kf_uv[..., 0]
    rv = fy * py * inv_z + cy - kf_uv[..., 1]
    chi2 = (ru * ru + rv * rv) * inv_sigma2
    nrm = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w_huber = torch.clamp(huber_delta / nrm, max=1.0)
    wgt = (obs_valid & (pz > 1e-3)).to(torch.float32) * w_huber * inv_sigma2
    xz = px * inv_z
    yz = py * inv_z
    zero = torch.zeros_like(z)
    Jp_u = torch.stack([fx * inv_z, zero, -fx * xz * inv_z,
                        -fx * xz * yz, fx * (1.0 + xz * xz), -fx * yz], 1)
    Jp_v = torch.stack([zero, fy * inv_z, -fy * yz * inv_z,
                        -fy * (1.0 + yz * yz), fy * xz * yz, fy * xz], 1)

    def Rc(i, j):
        return kf_R[:, i, j][:, None]

    Jt_u = torch.stack([fx * inv_z * Rc(0, b) - fx * xz * inv_z * Rc(2, b)
                        for b in range(3)], 1)
    Jt_v = torch.stack([fy * inv_z * Rc(1, b) - fy * yz * inv_z * Rc(2, b)
                        for b in range(3)], 1)
    return ru, rv, wgt, Jp_u, Jp_v, Jt_u, Jt_v, pz


def _block_assembly(om: ObsMap, ru, rv, wgt, Jp_u, Jp_v, Jt_u, Jt_v):
    """Returns H_pp (W,6,6), b_p (W,6), acc_t (12, ML) (landmark 3x3
    blocks + gradient, L-minor) and H_pl (W,18,ML)."""
    W, _, N = Jp_u.shape
    H_pp = torch.einsum('wan,wn,wbn->wab', Jp_u, wgt, Jp_u) \
        + torch.einsum('wan,wn,wbn->wab', Jp_v, wgt, Jp_v)
    b_p = torch.einsum('wan,wn->wa', Jp_u, wgt * ru) \
        + torch.einsum('wan,wn->wa', Jp_v, wgt * rv)
    Hpl_obs = torch.einsum('wan,wn,wcn->wacn', Jp_u, wgt, Jt_u) \
        + torch.einsum('wan,wn,wcn->wacn', Jp_v, wgt, Jt_v)
    Hll_obs = torch.einsum('wbn,wn,wcn->wbcn', Jt_u, wgt, Jt_u) \
        + torch.einsum('wbn,wn,wcn->wbcn', Jt_v, wgt, Jt_v)
    bl_obs = Jt_u * (wgt * ru)[:, None, :] + Jt_v * (wgt * rv)[:, None, :]
    vals_t = torch.cat([Hll_obs.reshape(W, 9, N), bl_obs], 1)   # (W,12,N)
    acc_t = om.seg_sum_t(vals_t.permute(1, 0, 2).reshape(12, W * N))
    H_pl = om.seg_sum_batched_t(Hpl_obs.reshape(W, 18, N))
    return H_pp, b_p, acc_t, H_pl


def _lm_block_inverse(acc_t, lam_it, lm_free):
    """Damped 3x3 inverses by the adjugate over the ML lanes.
    Returns (H_ll_inv (3,3,ML), b_l (3,ML))."""
    Hl = acc_t[:9].reshape(3, 3, -1)
    b_l = acc_t[9:]
    lam_l = lam_it * torch.clamp((Hl[0, 0] + Hl[1, 1] + Hl[2, 2]) / 3.0,
                                 min=1e-6)
    a_, b_, c_ = Hl[0, 0] + lam_l, Hl[0, 1], Hl[0, 2]
    d_, e_, f_ = Hl[1, 0], Hl[1, 1] + lam_l, Hl[1, 2]
    g_, h_, i_ = Hl[2, 0], Hl[2, 1], Hl[2, 2] + lam_l
    A_ = e_ * i_ - f_ * h_
    B_ = c_ * h_ - b_ * i_
    C_ = b_ * f_ - c_ * e_
    D_ = f_ * g_ - d_ * i_
    E_ = a_ * i_ - c_ * g_
    F_ = c_ * d_ - a_ * f_
    G_ = d_ * h_ - e_ * g_
    H_ = b_ * g_ - a_ * h_
    I_ = a_ * e_ - b_ * d_
    det = a_ * A_ + b_ * D_ + c_ * G_
    big = det.abs() > 1e-12
    inv_det = torch.where(lm_free & big,
                          1.0 / torch.where(big, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    H_ll_inv = torch.stack([torch.stack([A_, B_, C_]),
                            torch.stack([D_, E_, F_]),
                            torch.stack([G_, H_, I_])]) * inv_det
    return H_ll_inv, b_l


def _schur_solve(H_pp, b_p, acc_t, H_pl, lam_it, lm_free, pose_free):
    """Eliminate landmarks, solve the reduced camera system,
    back-substitute. Returns (delta_p (W,6), delta_lt (3,ML))."""
    W = H_pp.shape[0]
    dev = H_pp.device
    H_ll_inv, b_l = _lm_block_inverse(acc_t, lam_it, lm_free)
    T = torch.einsum('wabl,bcl->wacl', H_pl, H_ll_inv)          # (W,6,3,ML)
    A2 = T.reshape(W * 6, -1)
    B2 = H_pl.reshape(W * 6, -1)
    S = (A2 @ B2.T).reshape(W, 6, W, 6).permute(0, 2, 1, 3)
    b_red = b_p - (A2 @ b_l.reshape(-1)).reshape(W, 6)

    eye6 = torch.eye(6, dtype=H_pp.dtype, device=dev)
    lam_p = lam_it * torch.clamp(
        torch.einsum('waa->w', H_pp)[:, None, None] / 6.0, min=1e-6)
    ar = torch.arange(W, device=dev)
    S_full = -S
    S_full[ar, ar] = S_full[ar, ar] + H_pp + lam_p * eye6
    free = pose_free.to(torch.float32)
    S_full = S_full * (free[:, None] * free[None, :])[:, :, None, None]
    S_full[ar, ar] = S_full[ar, ar] + (1.0 - free)[:, None, None] * eye6
    b_red = b_red * free[:, None]
    A = S_full.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
    delta_p = -torch.linalg.solve_ex(A, b_red.reshape(-1)[:, None])[0][:, 0]
    delta_p = delta_p.reshape(W, 6) * free[:, None]

    Hpl_dp = torch.einsum('wacl,wa->cl', H_pl, delta_p)
    delta_lt = -torch.einsum('bcl,cl->bl', H_ll_inv, b_l + Hpl_dp)
    return delta_p, delta_lt * lm_free[None, :]


def _robust_cost(ru, rv, inv_sigma2, mask, pz, huber_delta):
    chi2 = (ru * ru + rv * rv) * inv_sigma2
    d2 = huber_delta * huber_delta
    rho = torch.where(chi2 <= d2, chi2,
                      2.0 * huber_delta * torch.sqrt(torch.clamp(chi2, min=1e-12))
                      - d2)
    return torch.where(mask & (pz > 1e-3), rho, torch.zeros_like(rho)).sum()


def _prune_obs(kf_obs, obs_valid, chi2, pz, prune, chi2_prune_mult,
               max_prune_frac: float = 0.25):
    """Drop window observations over the chi2 bound, per keyframe only
    while the violators are a minority of its live observations."""
    bad_obs = obs_valid & ((chi2 > chi2_prune_mult * CHI2_2DOF) | (pz <= 1e-3))
    n_bad = bad_obs.to(torch.float32).sum(-1, keepdim=True)
    n_live = torch.clamp(obs_valid.to(torch.float32).sum(-1, keepdim=True),
                         min=1.0)
    healthy = n_bad <= max_prune_frac * n_live
    if isinstance(prune, bool):
        if not prune:
            return kf_obs
        cut = healthy & bad_obs
    else:
        cut = torch.as_tensor(prune, device=kf_obs.device) & healthy & bad_obs
    return torch.where(cut, torch.full_like(kf_obs, -1), kf_obs)


def local_bundle_adjustment(m: MapState, K, cfg: MapConfig, iters: int = 5,
                            huber_delta: float = 2.447, damping=1e-3,
                            scale_factor: float = 1.2, n_fixed: int = 2,
                            window_ids=None, prune=True,
                            chi2_prune_mult: float = 4.0) -> MapState:
    """BA over a keyframe window (default: the newest cfg.ba_window);
    returns the map with refined window poses and landmark positions.
    ``damping`` may be a tensor; with iters > 1 it halves per iteration,
    floored at 1% of its start. ``prune`` is a bool or a bool tensor."""
    MK, ML, N = m.max_keyframes, m.max_landmarks, m.n_keypoints
    dev = m.device
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    if window_ids is None:
        W = cfg.ba_window
        start = torch.clamp(m.n_kf - W, min=0)
        win_ids = start + torch.arange(W, dtype=torch.int32, device=dev)
    else:
        W = window_ids.shape[0]
        win_ids = window_ids.to(device=dev, dtype=torch.int32)
    win_ok = win_ids < torch.clamp(m.n_kf, max=MK)
    gid = torch.clamp(win_ids, 0, MK - 1).long()

    kf_R, kf_t = m.kf_R[gid], m.kf_t[gid]
    kf_uv, kf_oct = m.kf_uv[gid], m.kf_octave[gid]
    kf_obs = m.kf_obs_lm[gid]
    kf_ok = m.kf_valid[gid] & win_ok
    lm_idx = torch.clamp(kf_obs, 0, ML - 1).long()
    obs_valid = (kf_obs >= 0) & m.kf_kp_valid[gid] & kf_ok[:, None] \
        & m.lm_valid[lm_idx]
    inv_sigma2 = 1.0 / (scale_factor ** (2.0 * kf_oct.to(torch.float32)))

    n_valid_w = kf_ok.sum()
    n_anchor = torch.clamp(torch.clamp(n_valid_w - 1, min=1), max=n_fixed)
    pose_free = kf_ok & (torch.arange(W, device=dev) >= n_anchor)
    damping = torch.as_tensor(damping, dtype=torch.float32, device=dev)

    om = ObsMap(torch.where(obs_valid, lm_idx,
                            torch.full_like(lm_idx, ML)).reshape(-1), ML)
    n_obs = om.seg_sum(torch.ones((W * N, 1), dtype=torch.float32,
                                  device=dev))[:, 0]
    lm_free = (n_obs >= 2.0) & m.lm_valid

    def planes(X_t):
        return (X_t[0].reshape(W, N), X_t[1].reshape(W, N),
                X_t[2].reshape(W, N))

    def residuals(R, t, X_t):
        px, py, pz = _project_planes(R, t, *planes(X_t))
        z = torch.clamp(pz, min=1e-6)
        return (fx * px / z + cx - kf_uv[..., 0],
                fy * py / z + cy - kf_uv[..., 1], pz)

    lm_pos = m.lm_pos
    X_t = om.gather_t(lm_pos.T)                                 # (3, W*N)
    for it in range(iters):
        lam_it = torch.clamp(damping * (0.5 ** it), min=damping * 1e-2)
        ru, rv, wgt, Jp_u, Jp_v, Jt_u, Jt_v, pz0 = _obs_terms(
            kf_R, kf_t, kf_uv, inv_sigma2, obs_valid, *planes(X_t),
            fx, fy, cx, cy, huber_delta)
        H_pp, b_p, acc_t, H_pl = _block_assembly(
            om, ru, rv, wgt, Jp_u, Jp_v, Jt_u, Jt_v)
        delta_p, delta_lt = _schur_solve(
            H_pp, b_p, acc_t, H_pl.reshape(W, 6, 3, ML), lam_it, lm_free,
            pose_free)
        dR, dt = se3_exp(delta_p)
        kf_R_new, kf_t_new = se3_compose(dR, dt, kf_R, kf_t)
        X_t_new = X_t + om.gather_t(delta_lt)
        c0 = _robust_cost(ru, rv, inv_sigma2, obs_valid, pz0, huber_delta)
        ru2, rv2, pz2 = residuals(kf_R_new, kf_t_new, X_t_new)
        c1 = _robust_cost(ru2, rv2, inv_sigma2, obs_valid, pz2, huber_delta)
        ok = c1 <= c0
        kf_R = torch.where(ok, kf_R_new, kf_R)
        kf_t = torch.where(ok, kf_t_new, kf_t)
        lm_pos = torch.where(ok, lm_pos + delta_lt.T, lm_pos)
        X_t = torch.where(ok, X_t_new, X_t)

    ru, rv, pz = residuals(kf_R, kf_t, X_t)
    chi2 = (ru * ru + rv * rv) * inv_sigma2
    kf_obs_pruned = _prune_obs(kf_obs, obs_valid, chi2, pz, prune,
                               chi2_prune_mult)
    sid = torch.where(kf_ok, gid, torch.full_like(gid, MK))
    return m.replace(kf_R=set_rows(m.kf_R, sid, kf_R),
                     kf_t=set_rows(m.kf_t, sid, kf_t),
                     kf_obs_lm=set_rows(m.kf_obs_lm, sid, kf_obs_pruned),
                     lm_pos=lm_pos)


def wide_bundle_adjustment(m: MapState, K, cfg: MapConfig,
                           max_window: int = 64, iters: int = 5) -> MapState:
    """Drift polish: BA over up to ``max_window`` recent keyframes."""
    wide = dataclasses.replace(
        cfg, ba_window=min(cfg.max_keyframes, max_window))
    return local_bundle_adjustment(m, K, wide, iters=iters)


def global_bundle_adjustment(m: MapState, K, cfg: MapConfig,
                             iters: int = 8) -> MapState:
    """Whole-map BA over every keyframe slot (W = max_keyframes)."""
    whole = dataclasses.replace(cfg, ba_window=cfg.max_keyframes)
    return local_bundle_adjustment(m, K, whole, iters=iters)


def ba_slice(m: MapState, K, cfg: MapConfig, window_ids, lam,
             prune=False, n_fixed: int = 2, **kw) -> MapState:
    """ONE Gauss-Newton iteration over ``window_ids`` at damping
    ``lam``: the amortized form of local BA."""
    return local_bundle_adjustment(
        m, K, cfg, iters=1, damping=lam, window_ids=window_ids,
        prune=prune, n_fixed=n_fixed, **kw)
