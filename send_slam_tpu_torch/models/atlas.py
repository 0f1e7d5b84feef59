"""Atlas multi-map: a map frozen on a long tracking loss, and its weld
back into the active map once place recognition finds the overlap.

Counterpart of ``send_slam_tpu/models/atlas.py``. A frozen map is a
MapState kept on the device. The weld is three programs: the best
retrieval hit of the active keyframe's signature in the frozen map's
keyframe table; a Sim(3) RANSAC between the two maps' world-frame
landmark clouds, paired through a mutual descriptor match of one
keyframe of each; and the import of the frozen keyframes (a new chain
segment after the active ones) and landmarks (into free slots, the most
found first) under that Sim(3). The System decides when to freeze and
when to try a weld (``models/system.py``).

The RANSAC draws are a parameter: ``noise`` (n_hyp, N) Gumbel values,
as ``models/sim3_solver.py`` takes them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from send_slam_tpu_torch.config import TrackingConfig
from send_slam_tpu_torch.models.map_state import MapState, set_rows
from send_slam_tpu_torch.models.sim3_solver import Sim3Result, sim3_ransac
from send_slam_tpu_torch.ops.hamming import match_descriptors


def best_cross_map_candidate(frozen: MapState, query_signature
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best retrieval hit of a frame signature in a frozen map's
    keyframe table (the first of equal scores). Returns (kf_id int32,
    score)."""
    scores = torch.where(frozen.kf_valid,
                         frozen.kf_signature @ query_signature,
                         torch.full_like(frozen.kf_signature[:, 0], -1.0))
    best = torch.argmax(scores)
    return best.to(torch.int32), scores[best]


class CrossMapSim3(NamedTuple):
    ok: torch.Tensor
    n_matches: torch.Tensor
    sim3: Sim3Result          # active world <- frozen world


def cross_map_sim3(active: MapState, frozen: MapState, active_kf, frozen_kf,
                   noise, cfg: TrackingConfig,
                   min_matches: int = 12) -> CrossMapSim3:
    """S_af, which maps frozen-world points into the active world, from
    the descriptor matches between one keyframe of each map whose both
    sides observe a landmark."""
    dev = active.device
    ka = torch.as_tensor(active_kf, device=dev).long()
    kf = torch.as_tensor(frozen_kf, device=dev).long()
    N = active.n_keypoints
    lm_a = active.kf_obs_lm[ka]
    lm_f_row = frozen.kf_obs_lm[kf]
    match = match_descriptors(
        active.kf_desc[ka], frozen.kf_desc[kf],
        active.kf_kp_valid[ka] & (lm_a >= 0),
        frozen.kf_kp_valid[kf] & (lm_f_row >= 0),
        max_dist=float(cfg.hamming_th_low), ratio=1e9, mutual=True)
    lm_f = lm_f_row[torch.clamp(match.idx, 0, N - 1)]
    pair_ok = match.valid & (lm_a >= 0) & (lm_f >= 0)
    Xa = active.lm_pos[torch.clamp(lm_a, 0, active.max_landmarks - 1).long()]
    Xf = frozen.lm_pos[torch.clamp(lm_f, 0, frozen.max_landmarks - 1).long()]
    res = sim3_ransac(Xf, Xa, pair_ok, noise)
    n_matches = pair_ok.sum()
    return CrossMapSim3(ok=res.ok & (n_matches >= min_matches),
                        n_matches=n_matches, sim3=res)


def weld_maps(active: MapState, frozen: MapState, s, R, t):
    """Import the frozen map into the active one under x_a = s R x_f + t.

    Frozen keyframes take the slots after ``active.n_kf`` in their own
    order (the first one starts a chain segment) while they fit; frozen
    landmarks take free slots, the most found first (ties in slot
    order), and the imported observation rows and reference keyframes
    are remapped. Returns (map, n_kf_imported, n_lm_imported)."""
    MK, ML = active.max_keyframes, active.max_landmarks
    dev = active.device
    i32 = dict(dtype=torch.int32, device=dev)
    ids = torch.arange(MK, **i32)

    # --- landmark id translation ---------------------------------------
    f_lm_valid = frozen.lm_valid
    order_key = torch.where(f_lm_valid, -frozen.lm_found,
                            torch.full_like(frozen.lm_found, 1 << 30))
    order = torch.argsort(order_key, stable=True)
    free = ~active.lm_valid
    free_rank = (torch.cumsum(free.to(torch.int32), 0) - 1).to(torch.int32)
    n_free = free.sum(dtype=torch.int32)
    ar = torch.arange(ML, **i32)
    slot_of_rank = set_rows(torch.full((ML,), ML, **i32),
                            torch.where(free, free_rank,
                                        torch.full_like(free_rank, ML)), ar)
    imp_rank = set_rows(torch.full((ML,), ML, **i32), order, ar)
    takes = f_lm_valid & (imp_rank < n_free)
    remap = torch.where(takes,
                        slot_of_rank[torch.clamp(imp_rank, 0, ML - 1).long()],
                        torch.full_like(imp_rank, ML))

    def lm(dst, src):
        return set_rows(dst, remap, src)

    # --- keyframe import -------------------------------------------------
    f_kf_valid = frozen.kf_valid & (ids < frozen.n_kf)
    f_rank = (torch.cumsum(f_kf_valid.to(torch.int32), 0) - 1).to(torch.int32)
    kf_takes = f_kf_valid & (f_rank < MK - active.n_kf)
    dst_slot = torch.where(kf_takes, active.n_kf + f_rank,
                           torch.full_like(f_rank, MK))
    n_kf_imp = kf_takes.sum(dtype=torch.int32)

    # Sim(3)-corrected poses, T_cw_a = T_cw_f S_fa, the scale folded into
    # the translation (the loop-closing convention).
    R_new = frozen.kf_R @ R.T
    t_new = s * frozen.kf_t - torch.einsum('kij,j->ki', R_new, t)

    # Observation rows follow the landmark translation; frozen landmarks
    # that did not fit lose their observations.
    f_obs = frozen.kf_obs_lm
    f_obs_new = torch.where(f_obs >= 0,
                            remap[torch.clamp(f_obs, 0, ML - 1).long()],
                            torch.full_like(f_obs, -1))
    f_obs_new = torch.where(f_obs_new >= ML, torch.full_like(f_obs_new, -1),
                            f_obs_new)
    f_ref = frozen.lm_ref_kf
    f_ref_c = torch.clamp(f_ref, 0, MK - 1).long()
    ref_slot = torch.where((f_ref >= 0) & kf_takes[f_ref_c],
                           dst_slot[f_ref_c], torch.full_like(f_ref, -1))
    cb = frozen.kf_chain_break | ((f_rank == 0) & kf_takes)

    def kf(dst, src):
        return set_rows(dst, dst_slot, src)

    m = active.replace(
        kf_R=kf(active.kf_R, R_new), kf_t=kf(active.kf_t, t_new),
        kf_timestamp=kf(active.kf_timestamp, frozen.kf_timestamp),
        kf_valid=kf(active.kf_valid, True),
        kf_uv=kf(active.kf_uv, frozen.kf_uv),
        kf_desc=kf(active.kf_desc, frozen.kf_desc),
        kf_octave=kf(active.kf_octave, frozen.kf_octave),
        kf_kp_valid=kf(active.kf_kp_valid, frozen.kf_kp_valid),
        kf_obs_lm=kf(active.kf_obs_lm, f_obs_new),
        kf_signature=kf(active.kf_signature, frozen.kf_signature),
        kf_chain_break=kf(active.kf_chain_break, cb),
        lm_pos=lm(active.lm_pos, s * (frozen.lm_pos @ R.T) + t[None]),
        lm_desc=lm(active.lm_desc, frozen.lm_desc),
        lm_valid=lm(active.lm_valid, True),
        lm_ref_kf=lm(active.lm_ref_kf, ref_slot),
        lm_visible=lm(active.lm_visible, frozen.lm_visible),
        lm_found=lm(active.lm_found, frozen.lm_found),
        # Viewing normals rotate; distances scale by s.
        lm_normal=lm(active.lm_normal, frozen.lm_normal @ R.T),
        lm_dist_min=lm(active.lm_dist_min, frozen.lm_dist_min * s),
        lm_dist_max=lm(active.lm_dist_max, frozen.lm_dist_max * s),
        lm_bit_votes=lm(active.lm_bit_votes, frozen.lm_bit_votes),
        lm_vote_count=lm(active.lm_vote_count, frozen.lm_vote_count),
        n_kf=active.n_kf + n_kf_imp)
    return m, n_kf_imp, (remap < ML).sum(dtype=torch.int32)
