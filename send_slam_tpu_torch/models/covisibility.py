"""Covisibility over the keyframe table: the local-BA window and
redundant-keyframe culling.

Counterpart of the ported part of ``send_slam_tpu/models/
covisibility.py``: the covisibility graph is recomputed on demand as one
(MK, ML) @ (ML, MK) product of the keyframe/landmark indicator; it gives
the local-BA window, the wide polish window and redundant-keyframe
culling. The pose-graph edges (``covis_edges``, ``chain_edges``) and
compaction belong to loop closing and capacity management, which later
slices port.
"""

from __future__ import annotations

import torch

from send_slam_tpu_torch.models.map_state import MapState, set_rows
from send_slam_tpu_torch.ops.orb import stable_topk


def kf_lm_indicator(m: MapState) -> torch.Tensor:
    """(MK, ML) f32: 1 where keyframe k observes landmark l."""
    MK, ML, N = m.max_keyframes, m.max_landmarks, m.n_keypoints
    obs = m.kf_obs_lm.long()
    ok = (obs >= 0) & m.kf_valid[:, None]
    rows = torch.arange(MK, device=m.device)[:, None].expand(MK, N)
    flat = torch.where(ok, rows * ML + obs, torch.full_like(obs, MK * ML))
    O = torch.zeros(MK * ML + 1, dtype=torch.float32, device=m.device)
    O[flat.reshape(-1)] = 1.0
    return O[:MK * ML].reshape(MK, ML)


def covisibility_matrix(m: MapState) -> torch.Tensor:
    """(MK, MK) shared-landmark counts, diagonal zeroed."""
    O = kf_lm_indicator(m)
    C = O @ O.T
    return C * (1.0 - torch.eye(m.max_keyframes, device=m.device))


def covis_window_ids(m: MapState, W: int):
    """The newest keyframe + its W-1 most covisible valid keyframes,
    sorted ascending, padded with MK. Returns (ids (W,) int32, valid)."""
    MK = m.max_keyframes
    cur = torch.clamp(m.n_kf - 1, 0, MK - 1).long()
    row = covisibility_matrix(m)[cur]
    ids = torch.arange(MK, device=m.device)
    eligible = m.kf_valid & (ids != cur) & (ids < m.n_kf)
    score = torch.where(eligible & (row > 0), row, torch.full_like(row, -1.0))
    top_v, top_i = stable_topk(score, W - 1)
    sel_ok = top_v > 0
    sel = torch.where(sel_ok, top_i, torch.full_like(top_i, MK))
    all_ids = torch.cat([sel, cur[None]])
    all_ok = torch.cat([sel_ok, torch.ones(1, dtype=torch.bool,
                                           device=m.device)])
    ids_sorted = torch.sort(torch.where(all_ok, all_ids,
                                        torch.full_like(all_ids, MK))).values
    return ids_sorted.to(torch.int32), ids_sorted < MK


def wide_window_ids(m: MapState, W: int):
    """Wide polish window: the newest W//2 keyframes plus the W - W//2
    keyframes most covisible with that recent set (ties to the lower
    slot, as ``lax.top_k``), sorted ascending, padded with MK.
    Returns (ids (W,) int32, valid (W,) bool)."""
    MK = m.max_keyframes
    ids = torch.arange(MK, device=m.device)
    n = torch.clamp(m.n_kf, max=MK)
    R = W // 2
    recent = (ids >= n - R) & (ids < n) & m.kf_valid
    mass = (covisibility_matrix(m) * recent[None, :].to(torch.float32)).sum(1)
    eligible = m.kf_valid & (ids < n) & ~recent
    score = torch.where(eligible & (mass > 0), mass,
                        torch.full_like(mass, -1.0))
    top_v, top_i = stable_topk(score, W - R)
    sel = torch.where(top_v > 0, top_i, torch.full_like(top_i, MK))
    rec_sorted = torch.sort(torch.where(recent, ids,
                                        torch.full_like(ids, MK))).values[:R]
    all_ids = torch.cat([sel, rec_sorted])
    out = torch.sort(torch.where(all_ids < MK, all_ids,
                                 torch.full_like(all_ids, MK))).values
    return out.to(torch.int32), out < MK


def keyframe_redundancy(m: MapState, min_other_obs: int = 3) -> torch.Tensor:
    """(MK,) fraction of each keyframe's landmarks seen by at least
    ``min_other_obs`` other keyframes."""
    ML = m.max_landmarks
    n_obs = kf_lm_indicator(m).sum(0)
    obs = m.kf_obs_lm
    has = (obs >= 0) & m.kf_valid[:, None]
    cnt = n_obs[torch.clamp(obs, 0, ML - 1).long()]
    red = has & (cnt >= (min_other_obs + 1))
    return red.sum(1) / torch.clamp(has.sum(1), min=1)


def cull_redundant_keyframes(m: MapState, redundancy_th: float = 0.9,
                             keep_latest: int = 3, max_cull: int = 0):
    """Invalidate redundant keyframes (never the first two, the
    ``keep_latest`` newest or chain-break ones; at most ``max_cull`` per
    call when > 0) and re-anchor landmarks whose reference keyframe
    went. Returns (map, n_culled)."""
    MK, ML, N = m.max_keyframes, m.max_landmarks, m.n_keypoints
    dev = m.device
    ids = torch.arange(MK, device=dev)
    frac = keyframe_redundancy(m)
    protected = (ids < 2) | (ids >= m.n_kf - keep_latest) | m.kf_chain_break
    cand = m.kf_valid & (ids < m.n_kf) & ~protected & (frac > redundancy_th)
    if max_cull > 0:
        score = torch.where(cand, frac, torch.full_like(frac, -1.0))
        top_v, top_i = stable_topk(score, max_cull)
        keepers = set_rows(torch.zeros(MK, dtype=torch.bool, device=dev),
                           torch.where(top_v > 0, top_i,
                                       torch.full_like(top_i, MK)), True)
        cand = cand & keepers
    kf_valid = m.kf_valid & ~cand
    obs = torch.where(cand[:, None], torch.full_like(m.kf_obs_lm, -1),
                      m.kf_obs_lm)
    flat_lm = obs.reshape(-1).long()
    flat_kf = ids[:, None].expand(MK, N).reshape(-1)
    ok = (flat_lm >= 0) & kf_valid[flat_kf]
    min_ref = torch.full((ML + 1,), MK, dtype=torch.int64, device=dev)
    min_ref.scatter_reduce_(0, torch.where(ok, flat_lm,
                                           torch.full_like(flat_lm, ML)),
                            flat_kf, reduce="amin")
    min_ref = min_ref[:ML]
    ref = m.lm_ref_kf
    ref_culled = (ref >= 0) & cand[torch.clamp(ref, 0, MK - 1).long()]
    new_ref = torch.where(ref_culled & (min_ref < MK), min_ref.to(ref.dtype),
                          ref)
    m = m.replace(kf_valid=kf_valid, kf_obs_lm=obs, lm_ref_kf=new_ref)
    return m, cand.sum(dtype=torch.int32)
