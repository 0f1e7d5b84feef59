"""Local mapping: new landmarks between keyframes, duplicate fusion and
the keyframe-insertion step.

Counterpart of ``send_slam_tpu/models/local_mapping.py``:
epipolar-gated descriptor matching of unassociated keypoints, batched
triangulation with octave-scaled gates, twin-landmark fusion through the
new keyframe, and ``insert_keyframe_with_triangulation`` (cull, invert
the tracked matches into the observation row, append, refresh, then
triangulate against each reference in ``triangulate_backs`` in order),
and ``bootstrap_map``, the two-keyframe map that an init commit builds.
"""

from __future__ import annotations

import torch

from send_slam_tpu_torch.config import EngineConfig, TrackingConfig
from send_slam_tpu_torch.geometry.se3 import hat
from send_slam_tpu_torch.geometry.triangulate import triangulate_batch
from send_slam_tpu_torch.models.frame import Frame
from send_slam_tpu_torch.models.initializer import InitResult
from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
from send_slam_tpu_torch.models.map_state import (
    MapState, add_landmarks, cull_landmarks, insert_keyframe,
    refresh_landmarks, set_rows,
)
from send_slam_tpu_torch.ops.hamming import (
    match_descriptors, projection_window_mask,
)


def fundamental_from_poses(Ra, ta, Rb, tb, K):
    """F with x_b^T F x_a = 0 for camera-from-world poses."""
    R_ba = Rb @ Ra.T
    t_ba = tb - (R_ba @ ta[:, None])[:, 0]
    E = hat(t_ba) @ R_ba
    Kinv = torch.linalg.inv_ex(K)[0]
    return Kinv.T @ E @ Kinv


def epipolar_distance_matrix(F, uv_a, uv_b):
    """(N,2),(M,2) -> (N,M) distance of each b-point to each a-epiline."""
    pa = torch.cat([uv_a, torch.ones_like(uv_a[:, :1])], -1)
    lines = pa @ F.T
    pb = torch.cat([uv_b, torch.ones_like(uv_b[:, :1])], -1)
    num = (lines @ pb.T).abs()
    den = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[:, None]
    return num / torch.clamp(den, min=1e-9)


def create_new_landmarks(m: MapState, kf_new, kf_ref, K, cfg: TrackingConfig,
                         epi_th_px: float = 2.0, reproj_th2: float = 5.991,
                         min_parallax_cos: float = None,
                         scale_factor: float = 1.2, n_levels: int = 8):
    """Triangulate unassociated keypoint pairs between kf_new and kf_ref
    and append them as landmarks. Returns (map, n_created)."""
    if min_parallax_cos is None:
        min_parallax_cos = cfg.tri_min_parallax_cos
    Ra, ta = m.kf_R[kf_ref], m.kf_t[kf_ref]
    Rb, tb = m.kf_R[kf_new], m.kf_t[kf_new]
    uva, uvb = m.kf_uv[kf_ref], m.kf_uv[kf_new]
    desca, descb = m.kf_desc[kf_ref], m.kf_desc[kf_new]
    unassoc_a = (m.kf_obs_lm[kf_ref] < 0) & m.kf_kp_valid[kf_ref]
    unassoc_b = (m.kf_obs_lm[kf_new] < 0) & m.kf_kp_valid[kf_new]
    sigma2_a = scale_factor ** (2.0 * m.kf_octave[kf_ref].to(torch.float32))
    sigma2_b = scale_factor ** (2.0 * m.kf_octave[kf_new].to(torch.float32))

    F = fundamental_from_poses(Ra, ta, Rb, tb, K)
    epi = epipolar_distance_matrix(F, uva, uvb)
    epi_mask = epi * epi < (epi_th_px * epi_th_px) * sigma2_b[None, :]
    match = match_descriptors(desca, descb, unassoc_a, unassoc_b,
                              max_dist=float(cfg.hamming_th_low), ratio=0.7,
                              mutual=True, extra_mask=epi_mask)
    N = uva.shape[0]
    idx_b = torch.clamp(match.idx, 0, N - 1)
    x1, x2 = uva, uvb[idx_b]
    P1 = K @ torch.cat([Ra, ta[:, None]], 1)
    P2 = K @ torch.cat([Rb, tb[:, None]], 1)
    X = triangulate_batch(P1, P2, x1, x2)
    pa = X @ Ra.T + ta
    pb = X @ Rb.T + tb

    def reproj_err2(p, x):
        z = torch.clamp(p[:, 2], min=1e-6)
        uv = torch.stack([K[0, 0] * p[:, 0] / z + K[0, 2],
                          K[1, 1] * p[:, 1] / z + K[1, 2]], -1)
        return ((uv - x) ** 2).sum(-1)

    Ca = -(Ra.T @ ta[:, None])[:, 0]
    Cb = -(Rb.T @ tb[:, None])[:, 0]
    ra, rb = X - Ca[None], X - Cb[None]
    cos_par = (ra * rb).sum(-1) / torch.clamp(
        torch.linalg.norm(ra, dim=-1) * torch.linalg.norm(rb, dim=-1),
        min=1e-9)
    good = (match.valid & torch.isfinite(X).all(-1) & (pa[:, 2] > 1e-3)
            & (pb[:, 2] > 1e-3)
            & (reproj_err2(pa, x1) < reproj_th2 * sigma2_a)
            & (reproj_err2(pb, x2) < reproj_th2 * sigma2_b[idx_b])
            & (cos_par < min_parallax_cos))

    dist_a = torch.clamp(torch.linalg.norm(ra, dim=-1), min=1e-6)
    normal = ra / dist_a[:, None]
    oct_ref = m.kf_octave[kf_ref].to(torch.float32)
    dmax = dist_a * (scale_factor ** oct_ref)
    dmin = dmax / (scale_factor ** (n_levels - 1))
    kp_all = torch.arange(N, dtype=torch.int64, device=m.device)
    m, lm_id = add_landmarks(m, X, desca, good, kf_new, kf_ref, kp_all,
                             kf_new, idx_b, normal=normal, dist_min=dmin,
                             dist_max=dmax)
    return m, (lm_id >= 0).sum(dtype=torch.int32)


def fuse_duplicate_landmarks(m: MapState, kf_id, K, cfg: TrackingConfig,
                             radius_px: float = 4.0):
    """Merge twin landmarks that project onto a keypoint already bound
    to a different landmark of keyframe kf_id (into the older id).
    Returns (map, n_fused)."""
    ML = m.max_landmarks
    dev = m.device
    R, t = m.kf_R[kf_id], m.kf_t[kf_id]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    p = m.lm_pos @ R.T + t
    z = torch.clamp(p[:, 2], min=1e-6)
    uv_pred = torch.stack([fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy], -1)
    in_view = m.lm_valid & (p[:, 2] > 0.01)
    kp_uv = m.kf_uv[kf_id]
    window = projection_window_mask(uv_pred, kp_uv, radius_px)
    match = match_descriptors(m.lm_desc, m.kf_desc[kf_id], in_view,
                              m.kf_kp_valid[kf_id],
                              max_dist=float(cfg.hamming_th_low), ratio=1.01,
                              mutual=False, extra_mask=window)
    N = kp_uv.shape[0]
    other = m.kf_obs_lm[kf_id].long()[torch.clamp(match.idx, 0, N - 1)]
    ids = torch.arange(ML, device=dev)
    dup = match.valid & (other >= 0) & (other != ids) \
        & m.lm_valid[torch.clamp(other, 0, ML - 1)]
    keep = torch.minimum(ids, other)
    drop = torch.maximum(ids, other)
    spill = torch.full_like(ids, ML)
    remap = set_rows(ids, torch.where(dup, drop, spill),
                     torch.where(dup, keep, torch.zeros_like(keep)))
    obs = m.kf_obs_lm
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, 0, ML - 1).long()]
                      .to(obs.dtype), obs)
    dropped = set_rows(torch.zeros(ML, dtype=torch.bool, device=dev),
                       torch.where(dup, drop, spill), True)
    keep_safe = torch.where(dup, keep, spill)
    drop_c = torch.clamp(drop, 0, ML - 1)

    def add_into_keep(vals):
        out = torch.zeros((ML + 1,) + vals.shape[1:], dtype=vals.dtype,
                          device=dev)
        out.index_add_(0, keep_safe, vals)
        return out[:ML]

    m = m.replace(
        kf_obs_lm=obs, lm_valid=m.lm_valid & ~dropped,
        lm_visible=m.lm_visible + add_into_keep(m.lm_visible[drop_c]),
        lm_found=m.lm_found + add_into_keep(m.lm_found[drop_c]),
        lm_bit_votes=m.lm_bit_votes + add_into_keep(m.lm_bit_votes[drop_c]),
        lm_vote_count=m.lm_vote_count
        + add_into_keep(m.lm_vote_count[drop_c]))
    return m, dropped.sum(dtype=torch.int32)


def insert_keyframe_with_triangulation(
        m: MapState, R, t, frame, match_idx, match_inlier, K,
        cfg: TrackingConfig, n_triangulate_refs: int = 3, chain_break=False,
        scale_factor: float = 1.2, n_levels: int = 8,
        triangulate_backs=None):
    """Cull, invert the tracked lm -> kp matches into the new keyframe's
    observation row, append it, refresh landmark statistics, triangulate
    against earlier keyframes and fuse twins. Returns (map, kf_id,
    n_new_landmarks)."""
    N = frame.feat.capacity
    ML = m.max_landmarks
    dev = m.device
    m, _ = cull_landmarks(m)
    lm_rows = torch.arange(ML, dtype=torch.int32, device=dev)
    kp_of_lm = torch.where(match_inlier & m.lm_valid, match_idx,
                           torch.full_like(match_idx, N))
    obs = set_rows(torch.full((N,), -1, dtype=torch.int32, device=dev),
                   kp_of_lm, lm_rows)
    m, kf_id = insert_keyframe(m, R, t, frame.timestamp, frame.uv_und,
                               frame.feat.desc, frame.feat.octave,
                               frame.feat.valid, obs, chain_break=chain_break)
    m = refresh_landmarks(m, kf_id, scale_factor=scale_factor,
                          n_levels=n_levels)
    backs = (tuple(range(1, n_triangulate_refs + 1))
             if triangulate_backs is None else tuple(triangulate_backs))
    n_new = torch.zeros((), dtype=torch.int32, device=dev)
    for back in backs:
        kf_ref = torch.clamp(kf_id - back, min=0)
        m, n = create_new_landmarks(m, kf_id, kf_ref, K, cfg,
                                    scale_factor=scale_factor,
                                    n_levels=n_levels)
        n_new = n_new + n
    m, _ = fuse_duplicate_landmarks(m, kf_id, K, cfg)
    return m, kf_id, n_new


def bootstrap_map(m: MapState, fa: Frame, fb: Frame, init_res: InitResult,
                  K: torch.Tensor, cfg: EngineConfig) -> MapState:
    """KF0 (identity, frame ``fa``) + KF1 (the init pose, frame ``fb``) +
    the initial landmarks, then the post-init BA with KF0 fixed."""
    orb = cfg.orb
    N = fa.feat.capacity
    dev = m.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    no_obs = torch.full((N,), -1, dtype=torch.int32, device=dev)
    m, kf0 = insert_keyframe(m, eye, zero, fa.timestamp, fa.uv_und,
                             fa.feat.desc, fa.feat.octave, fa.feat.valid,
                             no_obs)
    m, kf1 = insert_keyframe(m, init_res.R, init_res.t, fb.timestamp,
                             fb.uv_und, fb.feat.desc, fb.feat.octave,
                             fb.feat.valid, no_obs)
    good = init_res.point_ok & init_res.matches.valid
    idx_b = torch.clamp(init_res.matches.idx, 0, N - 1)
    X = init_res.points
    dist = torch.clamp(torch.linalg.norm(X, dim=-1), min=1e-6)
    dmax = dist * (orb.scale_factor ** fa.feat.octave.to(torch.float32))
    dmin = dmax / (orb.scale_factor ** (orb.n_levels - 1))
    m, _ = add_landmarks(
        m, X, fa.feat.desc, good, kf0, kf0,
        torch.arange(N, dtype=torch.int64, device=dev), kf1, idx_b,
        normal=X / dist[:, None], dist_min=dmin, dist_max=dmax)
    return local_bundle_adjustment(m, K, cfg.map, iters=10, n_fixed=1)
