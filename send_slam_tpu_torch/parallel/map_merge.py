"""Cross-camera shared-map merge.

Counterpart of ``send_slam_tpu/parallel/map_merge.py``. Each lane's map
lives in its own monocular gauge, so a merge with a partner lane takes
descriptor-matched landmark correspondences (mutual, ratio 0.8), a
Sim(3) RANSAC between the two clouds, and imports the partner's
landmarks that are new to this map (no landmark of mine within a
distance relative to my scene's scale) and near the support cluster
that determined the Sim(3) (its error grows with the distance from it).
At most ``max_import`` rows are imported, with ``ref_kf = -1`` and no
observations; the zero-observation prune and the compaction keep them.

The ring (``multicam_merge_step``): lane i merges from lane (i + 1) % n,
its global successor, against the partners' tables as they were before
the call; repeated calls circulate the whole fleet's content.

The RANSAC draws MERGE_N_HYP 3-pair hypotheses where the reference
draws N_HYP (128); see MERGE_N_HYP. With the reference's draws injected
(``noise`` of any hypothesis count) the merge is the reference's.

The nearest-landmark distance of each partner landmark is computed in
row blocks (the reference broadcasts an (ML, ML, 3) difference: 3.2 GB
at 16384 landmarks), with the reference's arithmetic per element:
differences, squares, the sum of the three, the row minimum, then the
square root. The lanes merge one at a time, so peak memory is that of
one lane's merge.
"""

from __future__ import annotations

from typing import List

import torch

from send_slam_tpu_torch.config import TrackingConfig
from send_slam_tpu_torch.models.map_state import MapState, add_landmarks
from send_slam_tpu_torch.models.sim3_solver import gumbel_noise, sim3_ransac
from send_slam_tpu_torch.ops.hamming import match_descriptors
from send_slam_tpu_torch.parallel.mesh import Mesh
from send_slam_tpu_torch.parallel.multicam import lane_map, stack_maps

NEAREST_BLOCK_ELEMS = 1 << 24   # differences held at once (x3 floats)
# Hypotheses of a merge's Sim(3) RANSAC: a named divergence from the
# reference's N_HYP = 128. Two lanes' maps share 50-70 mutual matches on
# chip_smoke.py's lanes, and 0.65-14% of their 3-pair draws reach the 8
# inliers a merge needs. At 1%, 128 draws miss in one merge of four, so a
# float-rounding change in either map decided whether a merge took place;
# 1,024 draws miss once in 30,000 (at 0.65%, once in 800).
MERGE_N_HYP = 1024


def nearest_distance(pts: torch.Tensor, table: torch.Tensor,
                     table_valid: torch.Tensor,
                     block_elems: int = NEAREST_BLOCK_ELEMS) -> torch.Tensor:
    """(P,) distance from each of ``pts`` (P, 3) to the nearest valid
    row of ``table`` (M, 3) (inf when none is valid), in row blocks of
    at most ``block_elems`` point pairs."""
    rows = max(1, block_elems // max(table.shape[0], 1))
    inf = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
    out = []
    for s in range(0, pts.shape[0], rows):
        d = pts[s:s + rows, None, :] - table[None, :, :]
        d = d * d
        d2 = d[..., 0] + d[..., 1] + d[..., 2]
        d2 = torch.where(table_valid[None, :], d2, inf)
        out.append(torch.sqrt(d2.amin(1)))
    return torch.cat(out)


def merge_from_partner(
        m: MapState, partner_pos: torch.Tensor, partner_desc: torch.Tensor,
        partner_valid: torch.Tensor, noise: torch.Tensor,
        cfg: TrackingConfig, max_import: int = 512,
        dedup_dist: float = 0.05, trust_radius: float = 3.0,
        with_sim3: bool = False):
    """Align the partner's landmark table (ML, …) to mine by a Sim(3)
    over descriptor-matched landmarks and import its novel landmarks.
    ``noise`` (n_hyp, ML) holds the RANSAC's Gumbel draws. Returns (map,
    aligned_ok () bool, n_imported () int32), and the Sim3Result with
    ``with_sim3``; nothing is imported when the alignment fails."""
    ML = m.max_landmarks

    # 1. Correspondences by descriptor (tight threshold, mutual).
    match = match_descriptors(
        m.lm_desc, partner_desc, m.lm_valid, partner_valid,
        max_dist=float(cfg.hamming_th_low), ratio=0.8, mutual=True)
    idx = torch.clamp(match.idx, 0, ML - 1)
    src = partner_pos[idx]                      # partner frame
    dst = m.lm_pos                              # my frame
    res = sim3_ransac(src, dst, match.valid, noise.to(m.device))

    # 2. The partner cloud in my frame.
    aligned = res.s * (partner_pos @ res.R.T) + res.t

    # 3. Novelty: no landmark of mine within dedup_dist x my scene scale
    # (the RMS radius of my table about its centre).
    my_valid_f = m.lm_valid.to(torch.float32)
    n_mine = torch.clamp(my_valid_f.sum(), min=1.0)
    center = (m.lm_pos * my_valid_f[:, None]).sum(0) / n_mine
    scene = torch.sqrt(torch.where(m.lm_valid[:, None],
                                   (m.lm_pos - center) ** 2,
                                   torch.zeros_like(m.lm_pos)).sum()
                       / n_mine)
    th = dedup_dist * torch.clamp(scene, min=1e-6)
    nearest = nearest_distance(aligned, m.lm_pos, m.lm_valid)

    # Trust region: only partner landmarks within trust_radius x the RMS
    # radius of the Sim(3)'s inlier support, whose gauge error grows
    # with the distance from it.
    wi = (res.inlier & match.valid).to(torch.float32)
    wi_sum = torch.clamp(wi.sum(), min=1.0)
    c_sup = (src * wi[:, None]).sum(0) / wi_sum          # partner frame
    r_sup = torch.sqrt((wi * ((src - c_sup) ** 2).sum(-1)).sum() / wi_sum)
    d_sup = torch.linalg.norm(partner_pos - c_sup, dim=-1)
    near_support = d_sup <= trust_radius * torch.clamp(r_sup, min=1e-6)

    novel = partner_valid & (nearest > th) & res.ok & near_support
    # Keep the first max_import novel rows.
    order = torch.cumsum(novel.to(torch.int32), 0)
    pick = novel & (order <= max_import)

    no_obs = torch.full((ML,), m.n_keypoints, dtype=torch.int64,
                        device=m.device)
    m, lm_ids = add_landmarks(m, aligned, partner_desc, pick, ref_kf=-1,
                              kf_a=0, kp_idx_a=no_obs, kf_b=0,
                              kp_idx_b=no_obs)
    out = (m, res.ok, (lm_ids >= 0).sum(dtype=torch.int32))
    return out + (res,) if with_sim3 else out


def merge_noise(n_cam: int, max_landmarks: int, seed: int = 0,
                device=None) -> torch.Tensor:
    """(n_cam, MERGE_N_HYP, max_landmarks) Gumbel draws for one ring
    merge, from a CPU generator seeded with ``seed`` (the same numbers on
    every device)."""
    gen = torch.Generator().manual_seed(seed)
    return gumbel_noise(gen, (n_cam, MERGE_N_HYP, max_landmarks),
                        device or "cpu")


def multicam_merge_step(cfg, mesh: Mesh):
    """The ring merge: returns ``merge(maps, noises) -> (maps', ok (n,),
    n_imported (n,))`` for stacked lane maps (leaves with a lane axis)
    and ``noises`` (n, n_hyp, ML); lane i aligns with and imports from
    lane (i + 1) % n, each lane on its mesh device, the results stacked
    on the mesh's first device."""
    tr = cfg.tracking
    home = mesh.flat_devices()[0]

    def merge(maps: MapState, noises: torch.Tensor):
        n = maps.lm_valid.shape[0]
        merged: List[MapState] = []
        oks, imported = [], []
        for dev, block in mesh.lane_blocks(n):
            for k in block:
                j = (k + 1) % n
                m, ok, n_imp = merge_from_partner(
                    lane_map(maps, k, dev), maps.lm_pos[j].to(dev),
                    maps.lm_desc[j].to(dev), maps.lm_valid[j].to(dev),
                    noises[k], tr)
                merged.append(m)
                oks.append(ok.to(home))
                imported.append(n_imp.to(home))
        return stack_maps(merged, home), torch.stack(oks), \
            torch.stack(imported)

    return merge
