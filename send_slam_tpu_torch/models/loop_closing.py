"""Loop closing: retrieval -> Sim(3) verification -> pose-graph
correction.

Counterpart of ``send_slam_tpu/models/loop_closing.py``: candidate
lookup is one signature product against the keyframe table
(``models/retrieval.py``), verification a Sim(3) RANSAC over co-observed
landmarks (``models/sim3_solver.py``) for each candidate, and the
correction the Sim(3) pose-graph Gauss-Newton over the essential graph
(``models/pose_graph.py``), written back into keyframe poses and
landmarks. The System reads two scalars per keyframe (the candidate
score, the verdict) and the two reprojection medians of its sanity gate.

The RANSAC draws are a parameter: ``noise`` holds one (n_hyp, N) Gumbel
block per candidate, as the JAX package splits one key per candidate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from send_slam_tpu_torch.config import TrackingConfig
from send_slam_tpu_torch.geometry.camera import project
from send_slam_tpu_torch.models.covisibility import chain_edges, covis_edges
from send_slam_tpu_torch.models.map_state import MapState
from send_slam_tpu_torch.models.pose_graph import (
    PoseGraphEdges, concat_edges, optimize_pose_graph,
)
from send_slam_tpu_torch.models.retrieval import idf_weights, retrieval_scores
from send_slam_tpu_torch.models.sim3_solver import Sim3Result, sim3_ransac
from send_slam_tpu_torch.ops.hamming import match_descriptors
from send_slam_tpu_torch.ops.orb import stable_topk

N_HYP = 128     # RANSAC hypotheses per candidate (sim3_ransac's default)


def loop_candidate(m: MapState, kf_id, min_gap: int = 20
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best retrieval candidate for keyframe ``kf_id``, excluding
    its temporal neighbours. Returns (cand_id () int32, score ())."""
    cands, scores = loop_candidates(m, kf_id, min_gap, k=1)
    return cands[0], scores[0]


def loop_candidates(m: MapState, kf_id, min_gap: int = 20, k: int = 3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k retrieval candidates for keyframe ``kf_id``, excluding its
    temporal neighbours (ties to the lower slot, as ``lax.top_k``).
    Returns (cands (k,) int32, scores (k,))."""
    query = m.kf_signature[kf_id]
    idf = idf_weights(m.kf_signature, m.kf_valid)
    scores = retrieval_scores(m.kf_signature, query, idf=idf)
    ids = torch.arange(m.max_keyframes, device=m.device)
    ok = m.kf_valid & ((ids - kf_id).abs() >= min_gap)
    top_v, top_i = stable_topk(torch.where(ok, scores,
                                           torch.full_like(scores, -1.0)), k)
    return top_i.to(torch.int32), top_v


class LoopSim3(NamedTuple):
    ok: torch.Tensor
    n_matches: torch.Tensor
    sim3: Sim3Result          # S_ca: cand-camera-frame from kf-camera-frame


def compute_loop_sim3(m: MapState, kf_id, cand_id, noise,
                      cfg: TrackingConfig, min_matches: int = 12) -> LoopSim3:
    """Verify one candidate: descriptor-match the two keyframes'
    keypoints (mutual, no ratio test), keep pairs where both sides
    observe a landmark, and solve the camera-frame Sim(3) between the
    two landmark clouds, inside the scale band."""
    kf_id = torch.as_tensor(kf_id, device=m.device).long()
    cand_id = torch.as_tensor(cand_id, device=m.device).long()
    ML, N = m.max_landmarks, m.n_keypoints
    lm_a = m.kf_obs_lm[kf_id]
    lm_c_row = m.kf_obs_lm[cand_id]
    valid_a = m.kf_kp_valid[kf_id] & (lm_a >= 0)
    valid_c = m.kf_kp_valid[cand_id] & (lm_c_row >= 0)
    match = match_descriptors(m.kf_desc[kf_id], m.kf_desc[cand_id], valid_a,
                              valid_c, max_dist=float(cfg.hamming_th_low),
                              ratio=1e9, mutual=True)
    lm_c = lm_c_row[torch.clamp(match.idx, 0, N - 1)]
    pair_ok = match.valid & (lm_a >= 0) & (lm_c >= 0)
    Xa = m.lm_pos[torch.clamp(lm_a, 0, ML - 1).long()]
    Xc = m.lm_pos[torch.clamp(lm_c, 0, ML - 1).long()]
    # Into the two camera frames: under drift the world positions of the
    # same landmarks disagree; the camera-frame clouds align under S_ca.
    pa = Xa @ m.kf_R[kf_id].T + m.kf_t[kf_id]
    pc = Xc @ m.kf_R[cand_id].T + m.kf_t[cand_id]
    res = sim3_ransac(pa, pc, pair_ok, noise)
    n_matches = pair_ok.sum()
    s_ok = (res.s > 1.0 / cfg.loop_max_scale) & (res.s < cfg.loop_max_scale)
    ok = res.ok & (n_matches >= min_matches) & s_ok
    return LoopSim3(ok=ok, n_matches=n_matches, sim3=res)


def compute_loop_sim3_multi(m: MapState, kf_id, cands, noise,
                            cfg: TrackingConfig, min_matches: int = 12
                            ) -> Tuple[LoopSim3, torch.Tensor]:
    """Verify every candidate (``noise`` (k, n_hyp, N), one block each)
    and keep the verified one with the most inliers (the first of
    equals). Returns (its LoopSim3, its candidate id)."""
    res = [compute_loop_sim3(m, kf_id, cands[c], noise[c], cfg,
                             min_matches=min_matches)
           for c in range(cands.shape[0])]
    ok = torch.stack([r.ok for r in res])
    n_inl = torch.stack([r.sim3.n_inliers for r in res])
    bi = torch.argmax(torch.where(ok, n_inl, torch.full_like(n_inl, -1)))

    def pick(xs):
        return torch.stack(xs)[bi]

    sim3 = Sim3Result(*(pick([r.sim3[f] for r in res])
                        for f in range(len(Sim3Result._fields))))
    return LoopSim3(ok=ok[bi], n_matches=pick([r.n_matches for r in res]),
                    sim3=sim3), cands[bi]


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries with numpy's rule (the mean of the
    two middle values of an even count; NaN when there are none), as
    ``jnp.nanmedian``. ``torch.nanmedian`` returns the lower middle
    value instead."""
    x = x.reshape(-1)
    keep = ~torch.isnan(x)
    n = keep.sum()
    v = torch.sort(torch.where(keep, x, torch.full_like(x, float("inf"))))[0]
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=x.numel() - 1)
    med = v[lo] * 0.5 + v[hi] * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def map_reprojection_median(m: MapState, fx: float, fy: float, cx: float,
                            cy: float) -> torch.Tensor:
    """Median reprojection error (px) of every valid keyframe
    observation against the landmark table: the map-consistency scalar
    of the post-closure sanity gate."""
    ML = m.max_landmarks
    lm = torch.clamp(m.kf_obs_lm, 0, ML - 1).long()
    X = m.lm_pos[lm]                                          # (MK,N,3)
    p_cam = torch.einsum('kij,knj->kni', m.kf_R, X) + m.kf_t[:, None, :]
    err = torch.linalg.norm(project(p_cam, fx, fy, cx, cy) - m.kf_uv, dim=-1)
    ok = (m.kf_valid[:, None] & m.kf_kp_valid & (m.kf_obs_lm >= 0)
          & m.lm_valid[lm] & (p_cam[..., 2] > 1e-6))
    return nanmedian(torch.where(ok, err, torch.full_like(err, float("nan"))))


def apply_loop_correction(m: MapState, kf_id, cand_id, loop: LoopSim3,
                          pgo_iters: int = 15, covis_top_k: int = 5,
                          covis_min_shared: float = 30.0,
                          covis_max_gap: int = 0,
                          loop_edge_weight: float = 5.0) -> MapState:
    """Insert the loop edge (i = kf_id, j = cand_id, measuring S_ca),
    run the Sim(3) pose graph over chain + covisibility + loop edges,
    and write back SE(3) keyframe poses (scale folded into t) and
    landmarks moved with their reference keyframe, with their distance
    bands rescaled alike."""
    MK = m.max_keyframes
    dev = m.device
    loop_edge = PoseGraphEdges(
        i=torch.as_tensor(kf_id, device=dev).reshape(1).to(torch.int32),
        j=torch.as_tensor(cand_id, device=dev).reshape(1).to(torch.int32),
        s=loop.sim3.s[None], R=loop.sim3.R[None], t=loop.sim3.t[None],
        valid=loop.ok[None],
        weight=torch.tensor([loop_edge_weight], device=dev))
    edges = concat_edges(concat_edges(
        chain_edges(m), covis_edges(m, top_k=covis_top_k,
                                    min_shared=covis_min_shared,
                                    max_gap=covis_max_gap)), loop_edge)
    s_new, R_new, t_new = optimize_pose_graph(m.kf_R, m.kf_t, m.kf_valid,
                                              edges, iters=pgo_iters)
    t_se3 = t_new / torch.clamp(s_new[:, None], min=1e-9)

    # X' = S_new_rw^-1(S_old_rw(X)) with the reference keyframe r.
    ref = torch.clamp(m.lm_ref_kf, 0, MK - 1).long()
    p_cam = torch.einsum('lij,lj->li', m.kf_R[ref], m.lm_pos) + m.kf_t[ref]
    s_r = s_new[ref]
    X_new = torch.einsum('lji,lj->li', R_new[ref], p_cam - t_new[ref]) \
        / torch.clamp(s_r[:, None], min=1e-9)
    corrected = m.lm_valid & (m.lm_ref_kf >= 0)
    X_new = torch.where(corrected[:, None], X_new, m.lm_pos)
    band = torch.where(corrected, 1.0 / torch.clamp(s_r, min=1e-9),
                       torch.ones_like(s_r))
    return m.replace(kf_R=R_new, kf_t=t_se3, lm_pos=X_new,
                     lm_dist_min=m.lm_dist_min * band,
                     lm_dist_max=m.lm_dist_max * band)
