"""The SLAM map: a fixed-capacity struct of tensors.

Counterpart of ``send_slam_tpu/models/map_state.py``. ``MapState`` is a
dataclass of tensors with the JAX package's field names, shapes and
dtypes (descriptors as int32 words holding the uint32 bits). Mutations
are functional: each returns a new MapState whose changed fields are
fresh tensors, so a caller may keep an older map (the JAX semantics).
Slot allocation is masked cumsum arithmetic, as in the reference.

``map_from_numpy`` / ``map_to_numpy`` carry a map between the two
packages as a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from send_slam_tpu_torch.config import MapConfig
from send_slam_tpu_torch.models.retrieval import N_BUCKETS, frame_signature
from send_slam_tpu_torch.ops.hamming import unpack_bits
from send_slam_tpu_torch.ops.orb import pack_bits


@dataclasses.dataclass
class MapState:
    # --- keyframes -----------------------------------------------------
    kf_R: torch.Tensor          # (MK,3,3) camera-from-world
    kf_t: torch.Tensor          # (MK,3)
    kf_timestamp: torch.Tensor  # (MK,)
    kf_valid: torch.Tensor      # (MK,) bool
    kf_uv: torch.Tensor         # (MK,N,2) undistorted keypoints
    kf_desc: torch.Tensor       # (MK,N,8) int32 (uint32 bits)
    kf_octave: torch.Tensor     # (MK,N) int32
    kf_kp_valid: torch.Tensor   # (MK,N) bool
    kf_obs_lm: torch.Tensor     # (MK,N) int32 landmark id or -1
    kf_signature: torch.Tensor  # (MK,B) f32
    kf_chain_break: torch.Tensor  # (MK,) bool
    # --- landmarks -----------------------------------------------------
    lm_pos: torch.Tensor        # (ML,3)
    lm_desc: torch.Tensor       # (ML,8) int32 (uint32 bits)
    lm_valid: torch.Tensor      # (ML,) bool
    lm_ref_kf: torch.Tensor     # (ML,) int32
    lm_visible: torch.Tensor    # (ML,) int32
    lm_found: torch.Tensor      # (ML,) int32
    lm_normal: torch.Tensor     # (ML,3) f32
    lm_dist_min: torch.Tensor   # (ML,) f32
    lm_dist_max: torch.Tensor   # (ML,) f32 (0 = no viewing stats)
    lm_bit_votes: torch.Tensor  # (ML,256) int32
    lm_vote_count: torch.Tensor  # (ML,) int32
    # --- counters ------------------------------------------------------
    n_kf: torch.Tensor          # () int32 keyframes appended so far

    @property
    def max_keyframes(self) -> int:
        return self.kf_R.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def n_keypoints(self) -> int:
        return self.kf_uv.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lm_pos.device

    def n_landmarks(self) -> torch.Tensor:
        return self.lm_valid.sum(dtype=torch.int32)

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)


_DESC_FIELDS = ("kf_desc", "lm_desc")


def map_to_numpy(m) -> Dict[str, np.ndarray]:
    """MapState (or LoopState) -> dict of numpy arrays in the JAX
    package's dtypes (descriptor words as uint32)."""
    out = {}
    for f in dataclasses.fields(m):
        a = getattr(m, f.name).detach().cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _DESC_FIELDS else a
    return out


def map_from_numpy(d, device=None) -> MapState:
    """Dict of numpy arrays (the JAX package's MapState fields, e.g.
    ``{k: np.asarray(v) for k, v in m._asdict().items()}``) -> MapState
    on ``device`` (default the card)."""
    from send_slam_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(MapState):
        a = np.asarray(d[f.name])
        if f.name in _DESC_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        kw[f.name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return MapState(**kw)


def empty_map(cfg: MapConfig, n_keypoints: int, device=None,
              dtype=torch.float32) -> MapState:
    from send_slam_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    MK, ML, N = cfg.max_keyframes, cfg.max_landmarks, n_keypoints
    i32 = dict(dtype=torch.int32, device=dev)
    f = dict(dtype=dtype, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return MapState(
        kf_R=torch.eye(3, **f).repeat(MK, 1, 1),
        kf_t=torch.zeros((MK, 3), **f),
        kf_timestamp=torch.zeros((MK,), **f),
        kf_valid=torch.zeros((MK,), **b),
        kf_uv=torch.zeros((MK, N, 2), **f),
        kf_desc=torch.zeros((MK, N, 8), **i32),
        kf_octave=torch.zeros((MK, N), **i32),
        kf_kp_valid=torch.zeros((MK, N), **b),
        kf_obs_lm=torch.full((MK, N), -1, **i32),
        kf_signature=torch.zeros((MK, N_BUCKETS), dtype=torch.float32,
                                 device=dev),
        kf_chain_break=torch.zeros((MK,), **b),
        lm_pos=torch.zeros((ML, 3), **f),
        lm_desc=torch.zeros((ML, 8), **i32),
        lm_valid=torch.zeros((ML,), **b),
        lm_ref_kf=torch.full((ML,), -1, **i32),
        lm_visible=torch.zeros((ML,), **i32),
        lm_found=torch.zeros((ML,), **i32),
        lm_normal=torch.zeros((ML, 3), **f),
        lm_dist_min=torch.zeros((ML,), **f),
        lm_dist_max=torch.zeros((ML,), **f),
        lm_bit_votes=torch.zeros((ML, 256), **i32),
        lm_vote_count=torch.zeros((ML,), **i32),
        n_kf=torch.zeros((), **i32),
    )


def set_rows(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Copy of ``arr`` with rows ``idx`` set to ``vals``; indices outside
    [0, len) are dropped (JAX's ``.at[idx].set(vals, mode="drop")``).
    Where an index repeats, its last row writes, on every device: a
    scatter on the card would otherwise let any of them win, and a run
    would not replay."""
    n = arr.shape[0]
    idx = idx.to(torch.int64).reshape(-1)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    if idx.shape[0] > 1:
        pos = torch.arange(idx.shape[0], device=idx.device)
        last = torch.full((n + 1,), -1, dtype=torch.int64,
                          device=idx.device).scatter_reduce_(0, idx, pos,
                                                             "amax")
        idx = torch.where(last[idx] == pos, idx, torch.full_like(idx, n))
    ext = torch.cat([arr, arr[:1]])
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    vals = vals.expand((idx.shape[0],) + arr.shape[1:])
    ext.index_put_((idx,), vals)
    return ext[:n]


def insert_keyframe(m: MapState, R, t, timestamp, kp_uv, kp_desc, kp_octave,
                    kp_valid, obs_lm, chain_break=False):
    """Append a keyframe at slot n_kf. Returns (map, kf_id)."""
    i = m.n_kf.reshape(1)
    dev = m.device
    ts = torch.as_tensor(timestamp, dtype=m.kf_timestamp.dtype, device=dev)
    cb = torch.as_tensor(chain_break, dtype=torch.bool, device=dev)
    m = m.replace(
        kf_chain_break=set_rows(m.kf_chain_break, i, cb.reshape(1)),
        kf_R=set_rows(m.kf_R, i, R[None]),
        kf_t=set_rows(m.kf_t, i, t[None]),
        kf_timestamp=set_rows(m.kf_timestamp, i, ts.reshape(1)),
        kf_valid=set_rows(m.kf_valid, i, True),
        kf_uv=set_rows(m.kf_uv, i, kp_uv[None]),
        kf_desc=set_rows(m.kf_desc, i, kp_desc[None]),
        kf_octave=set_rows(m.kf_octave, i, kp_octave[None]),
        kf_kp_valid=set_rows(m.kf_kp_valid, i, kp_valid[None]),
        kf_obs_lm=set_rows(m.kf_obs_lm, i, obs_lm[None]),
        kf_signature=set_rows(m.kf_signature, i,
                              frame_signature(kp_desc, kp_valid)[None]),
        n_kf=m.n_kf + 1,
    )
    return m, i[0].to(torch.int64)


def _free_slots(valid: torch.Tensor, n_new: int) -> torch.Tensor:
    """Indices of the first n_new invalid slots (padded with the last
    slot when the table overflows)."""
    size = valid.shape[0]
    order = torch.cumsum((~valid).to(torch.int64), 0) - 1
    idx = torch.arange(size, device=valid.device)
    cand = torch.where(~valid, order, torch.full_like(order, size + 1))
    hit = cand < n_new
    slots = torch.full((n_new + 1,), size - 1, dtype=torch.int64,
                       device=valid.device)
    slots.index_put_((torch.where(hit, cand, torch.full_like(cand, n_new)),),
                     idx)
    return slots[:n_new]


def _write_obs(obs, kf, kp_idx, good, lm_id):
    """obs[kf, kp_idx[j]] = lm_id[j] where good (others dropped)."""
    N = obs.shape[1]
    row = obs[kf]
    drop_kp = torch.where(good, kp_idx.to(torch.int64),
                          torch.full_like(kp_idx, N, dtype=torch.int64))
    new_row = set_rows(row, drop_kp, lm_id.to(obs.dtype))
    return set_rows(obs, kf.reshape(1).to(torch.int64), new_row[None])


def add_landmarks(m: MapState, pos, desc, good, ref_kf, kf_a, kp_idx_a,
                  kf_b, kp_idx_b, normal=None, dist_min=None, dist_max=None):
    """Insert up to P new landmarks at free slots and register their
    observations in keyframes kf_a / kf_b. Returns (map, lm_ids (P,)
    with -1 for rejected)."""
    P = pos.shape[0]
    ML = m.max_landmarks
    dev = m.device
    if normal is None:
        normal = torch.zeros((P, 3), dtype=pos.dtype, device=dev)
    if dist_min is None:
        dist_min = torch.zeros((P,), dtype=pos.dtype, device=dev)
    if dist_max is None:
        dist_max = torch.zeros((P,), dtype=pos.dtype, device=dev)
    rank = torch.cumsum(good.to(torch.int64), 0) - 1
    slots = _free_slots(m.lm_valid, P)
    minus1 = torch.full((P,), -1, dtype=torch.int64, device=dev)
    lm_id = torch.where(good, slots[torch.clamp(rank, 0, P - 1)], minus1)
    overflow = (~m.lm_valid).sum() <= rank
    lm_id = torch.where(overflow, minus1, lm_id)
    good = good & (lm_id >= 0)

    sidx = torch.where(good, lm_id, torch.full_like(lm_id, ML))
    ref = torch.as_tensor(ref_kf, device=dev).to(torch.int32)
    m2 = m.replace(
        lm_pos=set_rows(m.lm_pos, sidx, pos),
        lm_desc=set_rows(m.lm_desc, sidx, desc),
        lm_valid=set_rows(m.lm_valid, sidx, True),
        lm_ref_kf=set_rows(m.lm_ref_kf, sidx, ref.reshape(1)),
        lm_visible=set_rows(m.lm_visible, sidx, 1),
        lm_found=set_rows(m.lm_found, sidx, 1),
        lm_normal=set_rows(m.lm_normal, sidx, normal),
        lm_dist_min=set_rows(m.lm_dist_min, sidx, dist_min),
        lm_dist_max=set_rows(m.lm_dist_max, sidx, dist_max),
        lm_bit_votes=set_rows(m.lm_bit_votes, sidx,
                              unpack_bits(desc, torch.int32)),
        lm_vote_count=set_rows(m.lm_vote_count, sidx, 1),
    )
    kf_a = torch.as_tensor(kf_a, device=dev)
    kf_b = torch.as_tensor(kf_b, device=dev)
    obs = _write_obs(m.kf_obs_lm, kf_a, kp_idx_a, good, lm_id)
    obs = _write_obs(obs, kf_b, kp_idx_b, good, lm_id)
    return m2.replace(kf_obs_lm=obs), lm_id


def refresh_landmarks(m: MapState, kf_id, scale_factor: float = 1.2,
                      n_levels: int = 8) -> MapState:
    """Fold keyframe kf_id's observations into the landmarks' mean
    viewing normals, descriptor bit votes (majority descriptor) and
    scale-invariance bands. The per-landmark sums the JAX package takes
    with an exact one-hot matmul are index_add_ sums here."""
    ML = m.max_landmarks
    dev = m.device
    kf_id = torch.as_tensor(kf_id, device=dev).to(torch.int64)
    obs = m.kf_obs_lm[kf_id].to(torch.int64)                 # (N,)
    slot = torch.where(obs >= 0, obs, torch.full_like(obs, ML))

    def per_lm(vals):
        out = torch.zeros((ML + 1,) + vals.shape[1:], dtype=vals.dtype,
                          device=dev)
        out.index_add_(0, slot, vals)
        return out[:ML]

    has_obs = per_lm(torch.ones_like(slot, dtype=torch.float32)) > 0.5

    R, t = m.kf_R[kf_id], m.kf_t[kf_id]
    C = -(R.T @ t[:, None])[:, 0]
    d = m.lm_pos - C[None]
    dirs = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-6)
    add_dir = torch.where(has_obs[:, None], dirs, torch.zeros_like(dirs))
    mixed = m.lm_normal * m.lm_vote_count[:, None].to(m.lm_pos.dtype) \
        + add_dir
    nrm = torch.linalg.norm(mixed, dim=-1, keepdim=True)
    new_normal = torch.where(nrm > 1e-6, mixed / torch.clamp(nrm, min=1e-6),
                             m.lm_normal)

    bits = unpack_bits(m.kf_desc[kf_id], torch.int32)          # (N,256)
    votes = m.lm_bit_votes + per_lm(bits)
    vcnt = m.lm_vote_count + has_obs.to(torch.int32)
    new_desc = pack_bits(2 * votes > vcnt[:, None])
    lm_desc = torch.where((m.lm_valid & (vcnt > 0))[:, None], new_desc,
                          m.lm_desc)

    oct_row = per_lm(m.kf_octave[kf_id].to(torch.float32))
    dist = torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-6)
    dmax_new = dist * scale_factor ** oct_row
    dmin_new = dmax_new / (scale_factor ** (n_levels - 1))
    upd = has_obs & m.lm_valid & (m.lm_dist_max > 0)
    return m.replace(
        lm_normal=new_normal, lm_bit_votes=votes, lm_vote_count=vcnt,
        lm_desc=lm_desc,
        lm_dist_min=torch.where(upd, dmin_new, m.lm_dist_min),
        lm_dist_max=torch.where(upd, dmax_new, m.lm_dist_max))


def update_landmark_stats(m: MapState, in_view, found) -> MapState:
    """Per-frame MapPoint::IncreaseVisible / IncreaseFound."""
    return m.replace(
        lm_visible=m.lm_visible + (in_view & m.lm_valid).to(torch.int32),
        lm_found=m.lm_found + (found & m.lm_valid).to(torch.int32))


def cull_landmarks(m: MapState, min_visible: int = 4,
                   min_found_ratio: float = 0.25, probation_kfs: int = 3):
    """Drop young landmarks that are seen but rarely matched; clear
    their observations. Returns (map, n_culled)."""
    vis = m.lm_visible.to(torch.float32)
    fnd = m.lm_found.to(torch.float32)
    young = m.lm_ref_kf >= (m.n_kf - probation_kfs)
    bad = m.lm_valid & young & (m.lm_visible >= min_visible) \
        & (fnd < min_found_ratio * vis)
    obs = m.kf_obs_lm
    obs_bad = bad[torch.clamp(obs, 0, m.max_landmarks - 1).long()] & (obs >= 0)
    obs = torch.where(obs_bad, torch.full_like(obs, -1), obs)
    return m.replace(lm_valid=m.lm_valid & ~bad, kf_obs_lm=obs), \
        bad.sum(dtype=torch.int32)


def prune_zero_obs_landmarks(m: MapState) -> MapState:
    """Invalidate landmarks with < 2 keyframe observations (merge
    imports with ref_kf < 0 are exempt) and clear dangling entries."""
    ML = m.max_landmarks
    flat = m.kf_obs_lm.reshape(-1).to(torch.int64)
    idx = torch.where(flat >= 0, flat, torch.full_like(flat, ML))
    counts = torch.zeros(ML + 1, dtype=torch.int32, device=m.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    keep = m.lm_valid & ((counts[:ML] >= 2) | (m.lm_ref_kf < 0))
    obs = m.kf_obs_lm
    dangling = (obs >= 0) & ~keep[torch.clamp(obs, 0, ML - 1).long()]
    obs = torch.where(dangling, torch.full_like(obs, -1), obs)
    return m.replace(lm_valid=keep, kf_obs_lm=obs)


def record_observations(m: MapState, kf_id, lm_ids, kp_idx, valid):
    """kf_obs_lm[kf_id, kp_idx[j]] = lm_ids[j] where valid."""
    kf_id = torch.as_tensor(kf_id, device=m.device)
    return m.replace(kf_obs_lm=_write_obs(m.kf_obs_lm, kf_id, kp_idx, valid,
                                          lm_ids))
