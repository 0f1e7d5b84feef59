"""Multi-camera SLAM lanes over a device mesh.

Counterpart of ``send_slam_tpu/parallel/multicam.py``. Each camera lane
runs the full per-frame pipeline of the JAX package's ``per_cam``: the
reference store and slide, the single-reference two-view init with the
translation-direction gate, the bootstrap, the young-map collapse probe,
tracking (the retrieval prior and a 64 px window when LOST), keyframe
insertion with local BA, the zero-observation prune and culling, the
lane reset, the in-lane capacity lifecycle (a forced cull and compaction
at MK - 1) and, optionally, per-lane loop closing. The state keeps the
JAX leaf layout: every field, and every ``MapState`` leaf, has a leading
lane axis.

Where the JAX lane computes every branch and keeps the one its mode
selects (masked selection, so that all shards run one SPMD program),
the port evaluates only the selected branch: the lanes' modes are read
on the host once per step, and each lane reads its few decisions
(init accepted, keyframe, reset, capacity, loop verdict) as it reaches
them. The branches are pure, so the results are the same. Tracking and
the landmark statistics still run in every mode, as in the reference:
they are the default next map, and the inlier count is summarised in
every mode.

The front end of a step is one ``make_frames`` call per mesh entry: one
FAST launch on the card for all of that entry's lanes and levels.

Randomness: each lane draws its RANSAC samples (init) and Gumbel noise
(loop verification) from its own CPU ``torch.Generator``, seeded from
(seed, lane) by ``init_multicam`` and carried in the state as its byte
state (``rng``), so a step is a function of its inputs and a same-seed
run replays. ``draws`` injects the JAX package's draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from send_slam_tpu_torch.config import EngineConfig
from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.models.covisibility import (
    compact_keyframes, cull_redundant_keyframes,
)
from send_slam_tpu_torch.models.frame import Frame, make_frames
from send_slam_tpu_torch.models.initializer import two_view_init
from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
from send_slam_tpu_torch.models.local_mapping import (
    bootstrap_map, insert_keyframe_with_triangulation,
)
from send_slam_tpu_torch.models.loop_closing import (
    N_HYP, apply_loop_correction, compute_loop_sim3, loop_candidate,
)
from send_slam_tpu_torch.models.map_state import (
    MapState, empty_map, map_from_numpy, map_to_numpy,
    prune_zero_obs_landmarks, update_landmark_stats,
)
from send_slam_tpu_torch.models.retrieval import frame_signature
from send_slam_tpu_torch.models.sim3_solver import gumbel_noise
from send_slam_tpu_torch.models.tracking import track_frame
from send_slam_tpu_torch.ops.orb import FrameFeatures
from send_slam_tpu_torch.parallel.mesh import Mesh

# Lane state-machine modes (the per-lane analogue of the System's
# tracking states).
MODE_NO_REF = 0        # waiting for a reference frame
MODE_HAS_REF = 1       # reference stored; trying two-view init
MODE_TRACKING = 2
MODE_LOST = 3


class MultiCamState(NamedTuple):
    maps: MapState          # every leaf has a leading (n_cam,) axis
    R: torch.Tensor         # (n_cam, 3, 3) current camera-from-world
    t: torch.Tensor         # (n_cam, 3)
    # --- per-lane state machine (all (n_cam,) unless noted) -------------
    mode: torch.Tensor      # int32, MODE_*
    ref_uv: torch.Tensor    # (n_cam, N, 2) the stored init reference
    ref_desc: torch.Tensor  # (n_cam, N, 8) int32 (uint32 bits)
    ref_valid: torch.Tensor  # (n_cam, N) bool
    ref_angle: torch.Tensor  # (n_cam, N)
    ref_oct: torch.Tensor   # (n_cam, N) int32
    ref_ts: torch.Tensor
    frames_since_kf: torch.Tensor  # int32
    inliers_at_kf: torch.Tensor    # int32
    lost_frames: torch.Tensor      # int32
    kf_total: torch.Tensor         # int32, keyframes ever inserted
    # --- per-lane loop closing ------------------------------------------
    loop_last_cand: torch.Tensor   # int32, the last probe's candidate
    loop_run: torch.Tensor         # int32, consecutive consistent probes
    kf_since_loop: torch.Tensor    # int32, keyframes since an applied one
    loops_total: torch.Tensor      # int32, closures applied
    # --- per-lane init discipline ---------------------------------------
    init_tdir: torch.Tensor        # (n_cam, 3) last acceptable t-direction
    init_rejects: torch.Tensor     # int32, consecutive t-dir vetoes
    init_v: torch.Tensor           # f32, init-pair baseline velocity
    init_commit_ts: torch.Tensor   # f32, commit timestamp
    probe_t0: torch.Tensor         # f32, first tracked ts after commit
    probe_pos0: torch.Tensor       # (n_cam, 3) position at probe_t0
    probe_armed: torch.Tensor      # bool, collapse probe pending
    collapse_resets: torch.Tensor  # int32, young-map discards
    # --- the port's own: each lane's CPU generator state (n_cam, S) uint8
    rng: torch.Tensor


_LANE_FIELDS = tuple(f for f in MultiCamState._fields
                     if f not in ("maps", "rng"))
_DESC_FIELDS = ("ref_desc",)
_MAP_FIELDS = tuple(f.name for f in dataclasses.fields(MapState))


def lane_generator(seed: int, lane: int) -> torch.Generator:
    """The CPU generator of ``lane`` in a run seeded with ``seed``."""
    ss = np.random.SeedSequence([seed, lane])
    return torch.Generator().manual_seed(int(ss.generate_state(1)[0]))


def _rng_states(seed: int, n_cam: int) -> torch.Tensor:
    return torch.stack([lane_generator(seed, c).get_state()
                        for c in range(n_cam)])


def init_multicam(cfg: EngineConfig, n_cam: int, device=None,
                  seed: int = 0) -> MultiCamState:
    """Fresh lanes on ``device`` (default the card): empty maps, every
    lane waiting for a reference, generators seeded from (seed, lane)."""
    dev = resolve_device(device)
    one = empty_map(cfg.map, cfg.orb.n_features, device=dev)
    maps = MapState(**{f: getattr(one, f).expand(
        (n_cam,) + getattr(one, f).shape).clone() for f in _MAP_FIELDS})
    N = cfg.orb.n_features
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return MultiCamState(
        maps=maps,
        R=torch.eye(3, **f32).repeat(n_cam, 1, 1),
        t=torch.zeros((n_cam, 3), **f32),
        mode=torch.zeros((n_cam,), **i32),
        ref_uv=torch.zeros((n_cam, N, 2), **f32),
        ref_desc=torch.zeros((n_cam, N, 8), **i32),
        ref_valid=torch.zeros((n_cam, N), dtype=torch.bool, device=dev),
        ref_angle=torch.zeros((n_cam, N), **f32),
        ref_oct=torch.zeros((n_cam, N), **i32),
        ref_ts=torch.zeros((n_cam,), **f32),
        frames_since_kf=torch.zeros((n_cam,), **i32),
        inliers_at_kf=torch.zeros((n_cam,), **i32),
        lost_frames=torch.zeros((n_cam,), **i32),
        kf_total=torch.zeros((n_cam,), **i32),
        loop_last_cand=torch.full((n_cam,), -1, **i32),
        loop_run=torch.zeros((n_cam,), **i32),
        # Large so the cooldown never blocks a lane's first closure.
        kf_since_loop=torch.full((n_cam,), 10 ** 6, **i32),
        loops_total=torch.zeros((n_cam,), **i32),
        init_tdir=torch.zeros((n_cam, 3), **f32),
        init_rejects=torch.zeros((n_cam,), **i32),
        init_v=torch.zeros((n_cam,), **f32),
        init_commit_ts=torch.zeros((n_cam,), **f32),
        probe_t0=torch.full((n_cam,), -1.0, **f32),
        probe_pos0=torch.zeros((n_cam, 3), **f32),
        probe_armed=torch.zeros((n_cam,), dtype=torch.bool, device=dev),
        collapse_resets=torch.zeros((n_cam,), **i32),
        rng=_rng_states(seed, n_cam))


def multicam_state_to_numpy(state: MultiCamState) -> Dict:
    """MultiCamState -> dict of numpy arrays with the JAX package's
    field names and dtypes (``"maps"`` a dict of MapState fields;
    descriptor words as uint32). The generator states are left out."""
    out = {"maps": map_to_numpy(state.maps)}
    for f in _LANE_FIELDS:
        a = getattr(state, f).detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f in _DESC_FIELDS else a
    return out


def multicam_state_from_numpy(d: Dict, device=None,
                              seed: int = 0) -> MultiCamState:
    """The inverse of ``multicam_state_to_numpy``, from a JAX
    MultiCamState's leaves as numpy arrays (``d["maps"]`` a dict of the
    MapState fields) onto ``device`` (default the card); the lanes'
    generators are seeded from (seed, lane) as ``init_multicam`` seeds
    them."""
    dev = resolve_device(device)
    kw = {}
    for f in _LANE_FIELDS:
        a = np.asarray(d[f])
        if f in _DESC_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        kw[f] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    n_cam = kw["mode"].shape[0]
    return MultiCamState(maps=map_from_numpy(d["maps"], device=dev),
                         rng=_rng_states(seed, n_cam), **kw)


def lane_map(maps: MapState, lane: int, device=None) -> MapState:
    """One lane's map out of the stacked maps (on ``device`` when given)."""
    return MapState(**{f: _to(getattr(maps, f)[lane], device)
                       for f in _MAP_FIELDS})


def stack_maps(maps: Sequence[MapState], device) -> MapState:
    """Lane maps -> one MapState whose leaves have a lane axis, on
    ``device``."""
    return MapState(**{f: torch.stack([_to(getattr(m, f), device)
                                       for m in maps])
                       for f in _MAP_FIELDS})


def _to(x: torch.Tensor, device) -> torch.Tensor:
    return x if device is None or x.device == device else x.to(device)


def _camera_matrix(cfg: EngineConfig, device) -> torch.Tensor:
    cam = cfg.camera
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32,
                        device=device)


def _lane_frames(cfg: EngineConfig, mesh: Mesh, imgs, tss) -> List[Frame]:
    """One make_frames call per mesh entry over its block of lanes."""
    imgs = torch.as_tensor(imgs)
    tss = torch.as_tensor(tss, dtype=torch.float32)
    frames: List[Frame] = []
    for dev, lanes in mesh.lane_blocks(imgs.shape[0]):
        frames += make_frames(imgs[lanes.start:lanes.stop],
                              tss[lanes.start:lanes.stop], cfg.orb,
                              cfg.camera, device=dev)
    return frames


def multicam_slam_step(cfg: EngineConfig, mesh: Mesh,
                       loop_closing: bool = False):
    """The full per-lane SLAM step over the mesh.

    Returns ``step(state, imgs (n_cam, H, W), tss (n_cam,), draws=None)
    -> (state', summary (n_cam, 10))``, the summary rows being
    [mode, n_inliers, n_kf, n_landmarks, twc_x, twc_y, twc_z, nfeat,
    kf_total, loops_total], stacked on the mesh's
    first device (the reference's all_gather). kf_total counts keyframes
    ever inserted (n_kf shrinks on the in-lane compaction).

    ``draws``, when given, holds one entry per lane: None, or a dict
    with ``"init"`` = (E sets (n_hyp, 8), H sets (n_hyp, 4)) for the
    two-view init and ``"loop"`` = (N_HYP, N) Gumbel noise for the loop
    verification; what an entry lacks is drawn from the lane's
    generator.

    ``loop_closing=True`` adds the per-lane single-candidate loop
    closure at keyframe rate (retrieval, Sim(3) verification,
    essential-graph correction, pose rebase) with the System's
    consistency, score-band and cooldown guards."""
    tr, orb = cfg.tracking, cfg.orb
    MK = cfg.map.max_keyframes
    N = orb.n_features
    cos_tdir = torch.cos(torch.deg2rad(torch.tensor(
        tr.init_tdir_max_deg, dtype=torch.float32)))
    home = mesh.flat_devices()[0]

    def per_cam(lane: Dict, m: MapState, frame: Frame, mode_h: int,
                draws: Optional[Dict], gen: torch.Generator):
        dev = m.device
        K = _camera_matrix(cfg, dev)
        cam = cfg.camera
        ts = frame.timestamp

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        false = torch.tensor(False, device=dev)
        mode = lane["mode"]
        R, t = lane["R"], lane["t"]
        ref_ts = lane["ref_ts"]
        fsk, iak, lost, kft = (lane["frames_since_kf"],
                               lane["inliers_at_kf"], lane["lost_frames"],
                               lane["kf_total"])
        init_tdir, init_rejects = lane["init_tdir"], lane["init_rejects"]
        init_v, init_commit_ts = lane["init_v"], lane["init_commit_ts"]
        probe_t0, probe_pos0 = lane["probe_t0"], lane["probe_pos0"]
        probe_armed = lane["probe_armed"]
        collapse_resets = lane["collapse_resets"]
        loop_last_cand, loop_run = lane["loop_last_cand"], lane["loop_run"]
        kf_since_loop, loops_total = (lane["kf_since_loop"],
                                      lane["loops_total"])
        nfeat = frame.feat.valid.sum(dtype=torch.int32)

        # ---- initialization attempt (MODE_HAS_REF only) ----------------
        init_res = None
        init_ok = false
        if mode_h == MODE_HAS_REF:
            sets = (draws or {}).get("init")
            init_res = two_view_init(
                lane["ref_uv"], lane["ref_desc"], lane["ref_valid"],
                lane["ref_angle"], frame.uv_und, frame.feat.desc,
                frame.feat.valid, frame.feat.angle, K, tr,
                generator=gen, sets=sets)
            acceptable = init_res.ok
            # Translation-direction consistency gate: two consecutive
            # acceptable candidates must agree before a commit; the
            # rejection cap bounds the wait.
            if tr.init_tdir_max_deg > 0.0:
                t_dir = init_res.t / torch.clamp(
                    torch.linalg.norm(init_res.t), min=1e-9)
                have_prev = (init_tdir * init_tdir).sum() > 0.25
                agree = have_prev & ((t_dir * init_tdir).sum()
                                     >= cos_tdir.to(dev))
                init_ok = acceptable & (
                    agree | (init_rejects >= tr.init_tdir_max_rejects))
                init_rejects = torch.where(
                    acceptable & ~agree, init_rejects + 1,
                    torch.where(acceptable & agree, i32(0), init_rejects))
                # The vetoed candidate still becomes the next yardstick.
                init_tdir = torch.where(acceptable, t_dir, init_tdir)
            else:
                init_ok = acceptable
            # Arm the young-map collapse probe at commit, with the
            # init pair's own baseline velocity.
            dt_init = torch.clamp(ts - ref_ts, min=1.0 / 120.0)
            twc_init = -(init_res.R.T @ init_res.t[:, None])[:, 0]
            v0 = torch.linalg.norm(twc_init) / dt_init
            arm0 = (tr.init_collapse_frac > 0.0) \
                & (collapse_resets < tr.init_collapse_max_resets)
            init_v = torch.where(init_ok, v0, init_v)
            init_commit_ts = torch.where(init_ok, ts, init_commit_ts)
            probe_t0 = torch.where(init_ok, f32(-1.0), probe_t0)
            probe_armed = torch.where(init_ok, arm0, probe_armed)

        # ---- tracking (TRACKING: motion prior; LOST: the best
        # retrieval keyframe's pose and a wide window) -------------------
        is_lost = mode_h == MODE_LOST
        if is_lost:
            sig = frame_signature(frame.feat.desc, frame.feat.valid)
            scores = torch.where(m.kf_valid, m.kf_signature @ sig,
                                 f32(-1.0))
            best = torch.argmax(scores)
            R_prior, t_prior, radius = m.kf_R[best], m.kf_t[best], 64.0
        else:
            R_prior, t_prior, radius = R, t, tr.search_radius_px
        res = track_frame(
            R_prior, t_prior, m.lm_pos, m.lm_desc, m.lm_valid,
            frame.uv_und, frame.feat.desc, frame.feat.valid,
            frame.feat.octave, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height, tr, scale_factor=orb.scale_factor,
            search_radius=radius, lm_normal=m.lm_normal,
            lm_dist_min=m.lm_dist_min, lm_dist_max=m.lm_dist_max,
            n_levels=orb.n_levels)
        n_inl = res.n_inliers.to(torch.int32)
        trackable = mode_h in (MODE_TRACKING, MODE_LOST)
        track_ok = (n_inl >= tr.min_track_matches) & trackable
        m_trk = update_landmark_stats(m, res.in_view, res.inlier)

        # ---- young-map scale-collapse probe: one windowed velocity
        # comparison after commit; a collapse resets the lane ----------
        twc_cur = -(res.R.T @ res.t[:, None])[:, 0]
        start = probe_armed & track_ok & (probe_t0 < 0.0)
        probe_t0 = torch.where(start, ts, probe_t0)
        probe_pos0 = torch.where(start, twc_cur, probe_pos0)
        span = ts - probe_t0
        expire = probe_armed & (ts - init_commit_ts
                                > tr.init_collapse_horizon_s)
        evaluate = probe_armed & track_ok & ~start & (probe_t0 >= 0.0) \
            & (span >= tr.init_collapse_window_s)
        v_est = torch.linalg.norm(twc_cur - probe_pos0) \
            / torch.clamp(span, min=1e-9)
        ratio = v_est / torch.clamp(init_v, min=1e-9)
        collapse = evaluate & (ratio < tr.init_collapse_frac)
        probe_pass = (evaluate & ~collapse) | (expire & ~evaluate)
        probe_armed = probe_armed & ~(evaluate | expire)
        collapse_resets = torch.where(
            collapse, collapse_resets + 1,
            torch.where(probe_pass, i32(0), collapse_resets))

        # ---- keyframe decision, lane reset -----------------------------
        weak = n_inl < (f32(tr.kf_tracked_ratio)
                        * torch.clamp(iak, min=1).to(torch.float32))
        stale = fsk >= tr.kf_max_interval
        do_kf = track_ok & (fsk >= tr.kf_min_interval) & (weak | stale) \
            & (m.n_kf < MK - 1)
        do_reset = (is_lost & ~track_ok & (lost > 10) & (m.n_kf <= 5)) \
            | collapse
        init_ok_h, do_kf_h, do_reset_h = (
            bool(v) for v in torch.stack([init_ok, do_kf, do_reset]).tolist())

        # ---- the next map: reset > boot > keyframe > track -------------
        if do_reset_h:
            m_next = empty_map(cfg.map, N, device=dev)
        elif init_ok_h:
            ref = Frame(feat=FrameFeatures(
                uv=lane["ref_uv"], response=torch.zeros_like(ref_ts),
                octave=lane["ref_oct"], angle=lane["ref_angle"],
                desc=lane["ref_desc"], valid=lane["ref_valid"]),
                uv_und=lane["ref_uv"], timestamp=ref_ts)
            m_next = bootstrap_map(m, ref, frame, init_res, K, cfg)
        elif do_kf_h:
            m_next, _, _ = insert_keyframe_with_triangulation(
                m_trk, res.R, res.t, frame, res.matches.idx,
                res.matches.valid & res.inlier, K, tr,
                scale_factor=orb.scale_factor, n_levels=orb.n_levels,
                triangulate_backs=tr.triangulate_backs)
            m_next = local_bundle_adjustment(m_next, K, cfg.map)
            # The LocalMapping tail: zero-observation pruning and
            # redundant-keyframe culling at keyframe rate.
            m_next = prune_zero_obs_landmarks(m_next)
            m_next, _ = cull_redundant_keyframes(m_next, max_cull=2)
        else:
            m_next = m_trk

        # ---- the in-lane capacity lifecycle: at MK - 1, force-cull the
        # most redundant unprotected keyframe and compact ---------------
        if int(m_next.n_kf) >= MK - 1:
            m_next, _ = cull_redundant_keyframes(
                m_next, redundancy_th=0.0, keep_latest=3, max_cull=1)
            m_next, _ = compact_keyframes(m_next)

        if init_ok_h:
            R_next, t_next = init_res.R, init_res.t
        else:
            R_next = torch.where(track_ok, res.R, R)
            t_next = torch.where(track_ok, res.t, t)

        # ---- optional per-lane loop closing at keyframe rate -----------
        if loop_closing and do_kf_h:
            kf_new = torch.clamp(m_next.n_kf - 1, 0, MK - 1)
            cand, score = loop_candidate(m_next, kf_new, tr.loop_min_gap_kf)
            in_range = (score > tr.loop_score_min) \
                & (score < tr.loop_score_max)
            consistent = (cand - loop_last_cand).abs() \
                <= tr.loop_consistency_radius
            run_n = torch.where(in_range, torch.where(
                consistent, loop_run + 1, i32(1)), i32(0))
            verify = in_range & (run_n >= tr.loop_consistency_kf) \
                & (kf_since_loop >= tr.loop_cooldown_kf)
            do_loop = False
            if bool(verify):
                noise = (draws or {}).get("loop")
                if noise is None:
                    noise = gumbel_noise(gen, (N_HYP, N), dev)
                loop = compute_loop_sim3(
                    m_next, kf_new, cand, noise.to(dev), tr,
                    min_matches=tr.loop_min_matches)
                do_loop = bool(loop.ok)
            if do_loop:
                m_loop = apply_loop_correction(m_next, kf_new, cand, loop)
                # Rebase the lane's pose by the newest keyframe's delta.
                cur = kf_new.long()
                dR = m_loop.kf_R[cur] @ m_next.kf_R[cur].T
                dt = m_loop.kf_t[cur] - dR @ m_next.kf_t[cur]
                m_next = m_loop
                R_next = dR @ R_next
                t_next = dR @ t_next + dt
            kf_since_loop = i32(0) if do_loop else kf_since_loop + 1
            loops_total = loops_total + int(do_loop)
            loop_run = run_n
            loop_last_cand = cand

        # ---- reference management: store on the first good frame, slide
        # when stale (1 s) or when its match support died --------------
        ref_fields = ("ref_uv", "ref_desc", "ref_valid", "ref_angle",
                      "ref_oct")
        cur_fields = (frame.uv_und, frame.feat.desc, frame.feat.valid,
                      frame.feat.angle, frame.feat.octave)
        if mode_h == MODE_HAS_REF:
            dead_ref = ~init_ok \
                & (init_res.n_good < tr.init_min_matches) \
                & (nfeat >= tr.init_min_matches)
            store_ref = (~init_ok & (ts - ref_ts > 1.0)) | dead_ref
        elif mode_h == MODE_NO_REF:
            store_ref = nfeat >= tr.init_min_matches
        else:
            store_ref = false
        out = {f: torch.where(store_ref, c, lane[f])
               for f, c in zip(ref_fields, cur_fields)}
        out["ref_ts"] = torch.where(store_ref, ts, ref_ts)

        # ---- mode transitions and counters -----------------------------
        tracked = track_ok if trackable else false
        missed = ~track_ok if trackable else false
        mode_n = mode
        mode_n = torch.where((mode == MODE_NO_REF) & store_ref,
                             i32(MODE_HAS_REF), mode_n)
        mode_n = torch.where(init_ok, i32(MODE_TRACKING), mode_n)
        mode_n = torch.where(tracked, i32(MODE_TRACKING), mode_n)
        mode_n = torch.where(missed, i32(MODE_LOST), mode_n)
        mode_n = torch.where(do_reset, i32(MODE_NO_REF), mode_n)

        lost_n = torch.where(missed & ~do_reset, lost + 1, i32(0))
        fsk_n = torch.where(do_kf | init_ok | do_reset, i32(0), fsk + 1)
        iak_n = (init_res.n_good.to(torch.int32) if init_ok_h
                 else torch.where(do_kf, n_inl, iak))
        kft_n = kft + do_kf.to(torch.int32) + 2 * init_ok.to(torch.int32)
        kft_n = torch.where(do_reset, i32(0), kft_n)
        loop_last_cand = torch.where(do_reset, i32(-1), loop_last_cand)
        loop_run = torch.where(do_reset, i32(0), loop_run)
        kf_since_loop = torch.where(do_reset, i32(10 ** 6), kf_since_loop)
        # The t-dir yardstick and the rejection counter survive reference
        # slides; both clear on a commit or a lane reset.
        clear = init_ok | do_reset
        init_tdir = torch.where(clear, torch.zeros_like(init_tdir), init_tdir)
        init_rejects = torch.where(clear, i32(0), init_rejects)
        probe_armed = probe_armed & ~do_reset

        twc = -(R_next.T @ t_next[:, None])[:, 0]
        summary = torch.cat([
            torch.stack([mode_n.to(torch.float32), n_inl.to(torch.float32),
                         m_next.n_kf.to(torch.float32),
                         m_next.n_landmarks().to(torch.float32)]),
            twc, torch.stack([nfeat.to(torch.float32),
                              kft_n.to(torch.float32),
                              loops_total.to(torch.float32)])])
        out.update(
            R=R_next, t=t_next, mode=mode_n, frames_since_kf=fsk_n,
            inliers_at_kf=iak_n, lost_frames=lost_n, kf_total=kft_n,
            loop_last_cand=loop_last_cand, loop_run=loop_run,
            kf_since_loop=kf_since_loop, loops_total=loops_total,
            init_tdir=init_tdir, init_rejects=init_rejects, init_v=init_v,
            init_commit_ts=init_commit_ts, probe_t0=probe_t0,
            probe_pos0=probe_pos0, probe_armed=probe_armed,
            collapse_resets=collapse_resets)
        return m_next, out, summary

    def step(state: MultiCamState, imgs, timestamps, draws=None):
        n_cam = state.mode.shape[0]
        frames = _lane_frames(cfg, mesh, imgs, timestamps)
        modes = state.mode.tolist()
        maps, lanes, rows, rngs = [], [], [], []
        for dev, block in mesh.lane_blocks(n_cam):
            for c in block:
                lane = {f: _to(getattr(state, f)[c], dev)
                        for f in _LANE_FIELDS}
                gen = torch.Generator()
                # A copy: set_state misreads a row view of the stack.
                gen.set_state(state.rng[c].clone())
                m, out, row = per_cam(
                    lane, lane_map(state.maps, c, dev), frames[c], modes[c],
                    None if draws is None else draws[c], gen)
                maps.append(m)
                lanes.append(out)
                rows.append(row)
                rngs.append(gen.get_state())
        new = MultiCamState(
            maps=stack_maps(maps, home), rng=torch.stack(rngs),
            **{f: torch.stack([_to(o[f], home) for o in lanes])
               for f in _LANE_FIELDS})
        return new, torch.stack([_to(r, home) for r in rows])

    return step


def multicam_track_step(cfg: EngineConfig, mesh: Mesh,
                        insert_keyframes: bool = True):
    """The tracking-only lane step.

    Returns ``step(state, imgs (n_cam, H, W), timestamps (n_cam,)) ->
    (state', n_inliers (n_cam,), total_inliers (), all_t (n_cam, 3))``:
    each lane tracks from its current pose and, with
    ``insert_keyframes``, inserts a keyframe with triangulation and
    runs local BA; the total is the sum over lanes (the reference's
    psum) and ``all_t`` the lanes' translations stacked on the mesh's
    first device (its all_gather)."""
    cam = cfg.camera
    home = mesh.flat_devices()[0]

    def per_cam(R_pred, t_pred, m: MapState, frame: Frame):
        K = _camera_matrix(cfg, m.device)
        res = track_frame(
            R_pred, t_pred, m.lm_pos, m.lm_desc, m.lm_valid,
            frame.uv_und, frame.feat.desc, frame.feat.valid,
            frame.feat.octave, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height, cfg.tracking, scale_factor=cfg.orb.scale_factor)
        m = update_landmark_stats(m, res.in_view, res.inlier)
        if insert_keyframes:
            m, _, _ = insert_keyframe_with_triangulation(
                m, res.R, res.t, frame, res.matches.idx,
                res.matches.valid & res.inlier, K, cfg.tracking)
            m = local_bundle_adjustment(m, K, cfg.map)
        return m, res.R, res.t, res.n_inliers.to(torch.int32)

    def step(state: MultiCamState, imgs, timestamps):
        n_cam = state.mode.shape[0]
        frames = _lane_frames(cfg, mesh, imgs, timestamps)
        outs = []
        for dev, block in mesh.lane_blocks(n_cam):
            for c in block:
                outs.append(per_cam(_to(state.R[c], dev),
                                    _to(state.t[c], dev),
                                    lane_map(state.maps, c, dev), frames[c]))
        R = torch.stack([_to(o[1], home) for o in outs])
        t = torch.stack([_to(o[2], home) for o in outs])
        n_inl = torch.stack([_to(o[3], home) for o in outs])
        new = state._replace(maps=stack_maps([o[0] for o in outs], home),
                             R=R, t=t)
        return new, n_inl, n_inl.sum(), t

    return step
