"""Covisibility over the keyframe table: the local-BA window,
redundant-keyframe culling and the essential graph's edges.

Counterpart of the ported part of ``send_slam_tpu/models/
covisibility.py``: the covisibility graph is recomputed on demand as one
(MK, ML) @ (ML, MK) product of the keyframe/landmark indicator; it gives
the local-BA window, the wide polish window, redundant-keyframe culling,
the pose graph's covisibility and chain edges, and the table compaction
of capacity management.
"""

from __future__ import annotations

import torch

from send_slam_tpu_torch.models.map_state import MapState, set_rows
from send_slam_tpu_torch.models.pose_graph import (
    PoseGraphEdges, relative_edges,
)
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


def covis_edges(m: MapState, top_k: int = 5, min_shared: float = 30.0,
                max_gap: int = 0) -> PoseGraphEdges:
    """Essential-graph covisibility edges: for every valid keyframe, its
    ``top_k`` strongest covisible partners (ties to the lower slot, as
    ``lax.top_k``) with at least ``min_shared`` shared landmarks,
    measured from the current poses. E = MK * top_k edges; i->j and
    j->i duplicates weight one constraint twice. Adjacent pairs are the
    chain's; ``max_gap > 0`` also drops pairs further apart."""
    MK = m.max_keyframes
    ids = torch.arange(MK, device=m.device)
    live = m.kf_valid & (ids < m.n_kf)
    eligible = live[:, None] & live[None, :]
    C = covisibility_matrix(m)
    top_v, top_j = stable_topk(torch.where(eligible, C,
                                           torch.full_like(C, -1.0)), top_k)
    i = ids[:, None].expand(MK, top_k).reshape(-1)
    j = top_j.reshape(-1)
    valid = (top_v.reshape(-1) >= min_shared) & m.kf_valid[i] \
        & ((i - j).abs() > 1)
    if max_gap > 0:
        valid = valid & ((i - j).abs() <= max_gap)
    return relative_edges(m.kf_R, m.kf_t, i, j, valid,
                          torch.ones(MK * top_k, dtype=torch.float32,
                                     device=m.device))


def chain_edges(m: MapState) -> PoseGraphEdges:
    """Spanning-tree edges between consecutive valid keyframes. A
    keyframe with ``kf_chain_break`` set starts a new segment: the edge
    into it is a relocalization jump, not motion, and is dropped."""
    MK = m.max_keyframes
    ids = torch.arange(MK, dtype=torch.int32, device=m.device)
    valid = m.kf_valid & (ids < m.n_kf)
    incl = torch.cummax(torch.where(valid, ids, torch.full_like(ids, -1)),
                        0).values
    prev = torch.cat([incl.new_full((1,), -1), incl[:-1]])
    e_ok = valid & (prev >= 0) & ~m.kf_chain_break
    return relative_edges(m.kf_R, m.kf_t, torch.clamp(prev, 0, MK - 1), ids,
                          e_ok, torch.ones(MK, dtype=torch.float32,
                                           device=m.device))


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


def compact_keyframes(m: MapState):
    """Pack the valid keyframes to the front of the table, keeping their
    order, and remap ``lm_ref_kf``. Returns (map, n_valid). As in the
    reference, the freed tail of the pose, timestamp, keypoint,
    descriptor and octave rows holds copies of slot MK - 1's."""
    MK = m.max_keyframes
    dev = m.device
    ids = torch.arange(MK, dtype=torch.int32, device=dev)
    valid = m.kf_valid & (ids < m.n_kf)
    rank = (torch.cumsum(valid.to(torch.int32), 0) - 1).to(torch.int32)
    n_valid = valid.sum(dtype=torch.int32)
    old_of = set_rows(torch.full((MK,), MK - 1, dtype=torch.int64,
                                 device=dev),
                      torch.where(valid, rank, torch.full_like(rank, MK)),
                      ids.to(torch.int64))
    slot_ok = ids < n_valid

    def take(arr, fill=None):
        out = arr[old_of]
        if fill is None:
            return out
        ok = slot_ok.reshape((MK,) + (1,) * (arr.dim() - 1))
        return torch.where(ok, out, torch.full_like(out, fill))

    ref = m.lm_ref_kf
    ref_c = torch.clamp(ref, 0, MK - 1).long()
    new_ref = torch.where((ref >= 0) & valid[ref_c], rank[ref_c],
                          torch.full_like(ref, -1))
    m = m.replace(
        kf_R=take(m.kf_R), kf_t=take(m.kf_t),
        kf_timestamp=take(m.kf_timestamp), kf_valid=slot_ok,
        kf_uv=take(m.kf_uv), kf_desc=take(m.kf_desc),
        kf_octave=take(m.kf_octave),
        kf_kp_valid=take(m.kf_kp_valid, fill=False),
        kf_obs_lm=take(m.kf_obs_lm, fill=-1),
        kf_signature=take(m.kf_signature, fill=0.0),
        kf_chain_break=take(m.kf_chain_break, fill=False),
        lm_ref_kf=new_ref, n_kf=n_valid)
    return m, n_valid
