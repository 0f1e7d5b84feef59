"""The System facade: host orchestration of the monocular tracking path.

Counterpart of ``send_slam_tpu/models/system.py`` at the JAX package's
default configuration: ``track_monocular`` with the multi-reference
two-view init (``_try_initialize`` / ``_init_multi`` / ``_commit_init``),
the map bootstrap and the init trajectory backfill, the young-map
scale-collapse probe with its held poses and its retry over the recent
images, the per-frame step (motion-model prediction, tracking, the keyframe
decision, keyframe insertion with triangulation, the insert BA burst and
the amortized one-iteration BA slices), the one-frame-late summary
handling with the same lag, the young-map reset at ``n_kf <= 5``, the
LOST transition and relocalization (retrieval candidates re-tracked
beside a PnP RANSAC), the per-keyframe map maintenance, the queued
young and wide polish slices with their large-correction chain rebase,
and loop closing: a retrieval probe at each keyframe, the Sim(3)
verification of its candidates, the pose-graph correction committed at
once and judged by a reprojection sanity gate a frame later (rolled back
on failure), then the queued global polish slices over every keyframe
slot; capacity management (the keyframe table compacted, with one
keyframe force-culled when compaction frees too little); the atlas (a
map frozen on a long relocalization failure, kept on the device, and
welded back under a cross-map Sim(3) when a new keyframe retrieves it);
and map checkpoints in the JAX package's npz format.

What the JAX package's jitted programs decide with ``lax.cond`` is a
Python branch here. Randomness (RANSAC minimal sets and the loop
verification's Gumbel draws) comes from a CPU ``torch.Generator`` reset
with the session, as the JAX System resets its PRNG key; on the CPU, it
draws the same numbers for a run on the card as for the same run on the
CPU. The port compiles nothing ahead of a run, so the JAX System's
warm-up readiness gate (``_tail_ready``) is always open here, and
``warmup`` runs each step once, synchronously, before the first frame. The JAX
System reads the loop phases' scalars through background fetches with
blocking reads; the port reads them synchronously at the same points,
one phase per drained frame, so the cadence is the same.

Refused at construction: pyramid scales other than 1.2.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from send_slam_tpu_torch.config import EngineConfig
from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.geometry.se3 import (
    quat_from_rotmat, se3_compose, se3_exp, se3_inverse, se3_log, so3_exp,
    so3_log,
)
from send_slam_tpu_torch.io import map_io
from send_slam_tpu_torch.models.atlas import (
    best_cross_map_candidate, cross_map_sim3, weld_maps,
)
from send_slam_tpu_torch.models.covisibility import (
    compact_keyframes, covis_window_ids, cull_redundant_keyframes,
    wide_window_ids,
)
from send_slam_tpu_torch.models.frame import Frame, make_frame
from send_slam_tpu_torch.models.initializer import InitResult, two_view_init
from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
from send_slam_tpu_torch.models.local_mapping import (
    bootstrap_map, insert_keyframe_with_triangulation,
)
from send_slam_tpu_torch.models.loop_closing import (
    N_HYP, apply_loop_correction, compute_loop_sim3_multi, loop_candidates,
    map_reprojection_median,
)
from send_slam_tpu_torch.models.map_state import (
    MapState, empty_map, prune_zero_obs_landmarks, update_landmark_stats,
)
from send_slam_tpu_torch.models.relocalize import relocalize
from send_slam_tpu_torch.models.retrieval import (
    frame_signature, idf_weights, retrieval_scores,
)
from send_slam_tpu_torch.models.sim3_solver import gumbel_noise
from send_slam_tpu_torch.models.tracking import track_frame
from send_slam_tpu_torch.ops.hamming import Matches
from send_slam_tpu_torch.ops.orb import stable_topk
from send_slam_tpu_torch.utils import profiling

# Tracking states (the wire protocol's values, io/protocol.py).
TRACKING_NO_IMAGES_YET = 0
TRACKING_NOT_INITIALIZED = 1
TRACKING_OK = 2
TRACKING_RECENTLY_LOST = 3
TRACKING_LOST = 4

# Summary vector layout (the only per-frame device->host read, one frame
# late): [n_inliers, twc(3), quat(4), kf_inserted, n_kf, kf_slot, n_lm].
S_INLIERS, S_POS, S_QUAT, S_KF, S_NKF, S_SLOT, S_NLM = 0, 1, 4, 8, 9, 10, 11


@dataclasses.dataclass
class LoopState:
    """Per-frame tracking state carried between frame steps."""

    R: torch.Tensor               # (3,3) current Tcw
    t: torch.Tensor               # (3,)
    R2: torch.Tensor              # one-older pose (motion model)
    t2: torch.Tensor
    has_vel: torch.Tensor         # () bool
    frames_since_kf: torch.Tensor  # () int32
    inliers_at_kf: torch.Tensor   # () int32
    ba_it: torch.Tensor           # () int32 BA slices since the last KF
    ba_window: torch.Tensor       # (W,) int32 covis window of newest KF
    weak_run: torch.Tensor        # () int32 consecutive weak frames

    def replace(self, **kw) -> "LoopState":
        return dataclasses.replace(self, **kw)


def loop_state_to_numpy(st: LoopState) -> Dict[str, np.ndarray]:
    return {f.name: getattr(st, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(st)}


def loop_state_from_numpy(d, device=None) -> LoopState:
    """Dict of numpy arrays (the JAX package's LoopState fields) ->
    LoopState on ``device`` (default the card)."""
    dev = resolve_device(device)
    return LoopState(**{
        f.name: torch.from_numpy(np.array(d[f.name], copy=True)).to(dev)
        for f in dataclasses.fields(LoopState)})


class RelocOut(NamedTuple):
    """Result of the multi-candidate relocalization step; ``use_pnp``
    says which branch won (the PnP RANSAC or a retrieval candidate)."""

    R: torch.Tensor
    t: torch.Tensor
    n_inliers: torch.Tensor
    use_pnp: torch.Tensor


class TrackOutput(NamedTuple):
    """Host-side result of one frame (the pose packet's contents)."""

    tracking_state: int
    position: Optional[np.ndarray]      # Twc translation (3,)
    orientation: Optional[np.ndarray]   # Twc unit quaternion (x,y,z,w)
    n_inliers: int
    timestamp: float
    n_landmarks: int = -1
    # Late-emitted poses of earlier frames, (timestamp, position,
    # orientation) triples: the init backfill and the poses held while
    # the collapse probe was pending. Trajectory consumers append them.
    backfill: tuple = ()


def _stack_frames(frames: List[Frame]) -> Frame:
    return Frame(
        feat=type(frames[0].feat)(*(torch.stack([getattr(f.feat, n)
                                                 for f in frames])
                                    for n in frames[0].feat._fields)),
        uv_und=torch.stack([f.uv_und for f in frames]),
        timestamp=torch.stack([f.timestamp for f in frames]))


def _index_result(res: InitResult, i: int) -> InitResult:
    return InitResult(*(Matches(*(f[i] for f in x)) if isinstance(x, Matches)
                        else x[i] for x in res))


class System:
    """Monocular SLAM engine on the card (or the CPU with device="cpu")."""

    def __init__(self, config: EngineConfig, device=None):
        self.cfg = config
        self.device = resolve_device(device)
        cam = config.camera
        tr, MK = config.tracking, config.map.max_keyframes
        self._K = torch.tensor(
            [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=self.device)
        # RANSAC draws come from a CPU generator on every device, so a
        # card run draws what the same run on the CPU draws.
        self._gen = torch.Generator()
        self._n_init_refs = len(tr.init_ref_gaps)
        self._n_backfill = max(max(tr.init_ref_gaps) - 1, 1)
        self._wide_cfg = dataclasses.replace(config.map,
                                             ba_window=min(MK, 64))
        self._glob_cfg = dataclasses.replace(config.map, ba_window=MK)
        # Frames through make_frame (each runs one FAST launch on the
        # card, over every pyramid level).
        self.frames_extracted = 0
        # track_monocular calls so far: the frame id of the spans.
        self.calls = 0
        # Survives reset(): the collapse detector must not loop forever
        # on a world whose inits keep committing badly.
        self._collapse_resets = 0
        # Session-wide observability (survives reset()): each
        # collapse-probe verdict, (commit ts, probe ts, velocity ratio,
        # passed) in session-relative seconds; polish slices run;
        # applied loop closures.
        self.collapse_probes: List[tuple] = []
        self.polish_slices_run: Dict[str, int] = {"wide": 0, "young": 0,
                                                  "global": 0}
        self.last_reloc: Optional[dict] = None
        self.loops_closed = 0
        self.session_loops_applied = 0
        # Frozen maps, kept on the device, and the welds done (both
        # survive reset()).
        self.atlas: List[MapState] = []
        self.welds_done = 0
        self.reset()

    # ------------------------------------------------------------------

    def _fresh_loop_state(self) -> LoopState:
        cfg, dev = self.cfg, self.device
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        zero = torch.zeros(3, dtype=torch.float32, device=dev)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        return LoopState(
            R=eye, t=zero, R2=eye, t2=zero,
            has_vel=torch.tensor(False, device=dev),
            frames_since_kf=i32(0), inliers_at_kf=i32(0),
            ba_it=i32(cfg.tracking.ba_slice_max),
            ba_window=torch.full((cfg.map.ba_window,), cfg.map.max_keyframes,
                                 dtype=torch.int32, device=dev),
            weak_run=i32(0))

    # Attributes that survive reset() and that warmup() restores.
    _SESSION_ATTRS = ("frames_extracted", "_collapse_resets",
                      "collapse_probes", "polish_slices_run", "last_reloc",
                      "loops_closed", "session_loops_applied", "atlas",
                      "welds_done")

    def warmup(self, image_dtype=np.uint8, block: bool = False) -> None:
        """Run every device step the session can reach once, on dummy
        inputs at the configured shapes, so that their one-off costs
        land before the first frame: the FAST kernel's nvcc build and
        load, the cuBLAS and cuSOLVER handles, the caching allocator's
        first growth at the configured capacities. The list is the JAX
        System's warmup (``send_slam_tpu/models/system.py:729-805``),
        which compiles the same programs; unlike it, the steps after the
        init run on a dummy map with a finite baseline (below).

        Call it on a fresh System: it ends in ``reset()`` (the RANSAC
        generator reseeded) with ``frames_extracted`` and the counters
        that survive a reset restored, so a warmed session's poses are
        bit-equal to an unwarmed one's. Unlike the JAX warmup it is
        synchronous: ``block`` is accepted and changes nothing, since
        there is no background tail to wait for (``_tail_ready`` is
        always open here). ``image_dtype`` is the dtype of the dummy
        frame-step image, as in the JAX warmup."""
        del block
        kept = {a: copy.copy(getattr(self, a)) for a in self._SESSION_ATTRS}
        cfg, dev = self.cfg, self.device
        cam = cfg.camera
        rng = np.random.default_rng(0)
        img_f = rng.uniform(0, 255, (cam.height, cam.width)).astype(
            np.float32)
        img_raw = rng.integers(0, 255, (cam.height, cam.width)).astype(
            image_dtype)
        frame = self._make_frame(img_f, 0.0)
        refs = _stack_frames([frame] * self._n_init_refs)
        res_m, _probes = self._init_multi(refs, frame, 1.0)
        # Two identical dummy views have no baseline: the two-view
        # result's t and points are not finite (the JAX warmup carries
        # the NaNs on; here a solver on the CPU would refuse them). The
        # map the later steps run on gets a finite one instead: a 0.1
        # baseline along x, every match kept, points 2-6 ahead.
        N = frame.feat.capacity
        pts = rng.uniform((-1.0, -1.0, 2.0), (1.0, 1.0, 6.0), (N, 3))
        every = torch.ones(N, dtype=torch.bool, device=dev)
        init_res = _index_result(res_m, 0)._replace(
            t=torch.tensor([-0.1, 0.0, 0.0], device=dev),
            points=torch.from_numpy(pts.astype(np.float32)).to(dev),
            point_ok=every, matches=Matches(
                idx=torch.arange(N, device=dev),
                dist=torch.zeros(N, device=dev), valid=every))
        m = self._bootstrap_map(self.map, frame, frame, init_res)
        self._backfill_step(m, init_res.R, init_res.t,
                            torch.zeros(self._n_backfill, device=dev),
                            [frame] * self._n_backfill)
        st = self._fresh_loop_state()
        m2, _st2, summary = self._frame_step(m, st, img_raw, 1.0)
        self._maintain_step(m2)
        _mw, dR, dt, big = self._wide_slice(m, 1e-3, False)
        self._young_slice(m, 1e-3, False)
        self._rebase_st_cond(st, dR, dt, big)
        self._global_slice(m, 1e-3, False)
        self._forced_cull_step(m)
        self._compact_step(m)
        self._covis_window(m)
        cands, _scores = self._loop_candidate(m, 1)
        loop, cand_sel = self._loop_sim3(m, 1, cands, self._loop_noise(m))
        self._loop_apply(m, 1, cand_sel, loop)
        self._reloc_step(m, frame)
        self._atlas_cand(m, m.kf_signature[0])
        aw = self._atlas_sim3(m, m, 0, 0, self._atlas_noise(m))
        self._atlas_weld(m, m, aw.sim3.s, aw.sim3.R, aw.sim3.t)
        summary.cpu()               # the device->host read path, and a sync
        self.reset()
        for a, v in kept.items():
            setattr(self, a, v)

    def get_tracking_state(self) -> int:
        return self.state

    def reset(self) -> None:
        cfg = self.cfg
        self._gen.manual_seed(0)
        self.map: MapState = empty_map(cfg.map, cfg.orb.n_features,
                                       device=self.device)
        self.state = TRACKING_NO_IMAGES_YET
        self._t0: Optional[float] = None
        self._st = self._fresh_loop_state()
        self._lost_frames = 0
        self._last_inliers = 0
        self._n_kf_host = 0        # keyframes ever inserted (monotonic)
        self._slots_used = 0       # host mirror of the map's n_kf (lagged)
        # The next keyframe's incoming chain edge crosses a
        # relocalization (recorded on the keyframe, kf_chain_break).
        self._reloc_boundary_next_kf = False
        self._reloc_failures = 0
        # Loop closing: the probe or verification in flight, the applied
        # closure awaiting its sanity verdict (dropped with the map), the
        # (candidate slot, run length) consistency counter, every
        # attempt's record and the cooldown anchor.
        self._pending_loop: Optional[dict] = None
        self._pending_loop_sanity: Optional[dict] = None
        self._loop_consistency: Optional[Tuple[int, int]] = None
        self.loop_attempts: List[tuple] = []
        self._last_loop_nkf = -(10 ** 9)
        # Polish queue: (kind, lam, prune) slices, one per frame.
        self._polish_queue: List[tuple] = []
        self._young_polish_done = False
        self._compact_cooldown = 0
        # The atlas weld probe or verification in flight.
        self._pending_weld: Optional[dict] = None
        # Set by _collapse_retry after its own reset, cleared by any
        # other: arms the young one-anchor re-solve.
        self._had_collapse_reset = False
        self._init_frames: collections.deque = collections.deque(
            maxlen=max(cfg.tracking.init_ref_gaps) + 1)
        self._init_best = None
        self._init_prev_cands = None
        self._init_tdir_rejects = 0
        self._pending: List[dict] = []
        self._ready: List[TrackOutput] = []
        self._last_out: Optional[TrackOutput] = None
        self._trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._kf_trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.init_attempts = 0
        self.init_commit_ts: Optional[float] = None
        # Young-map scale-collapse probe: the init pair's baseline
        # velocity, the streamed positions since the commit, the poses
        # held while it is pending, and late poses awaiting the next OK
        # output's backfill field.
        self._init_v: Optional[float] = None
        self._collapse_trace: List[tuple] = []
        self._collapse_active = False
        self._held_outputs: List[tuple] = []
        self._backfill_pending: List[tuple] = []
        # Raw frames (host references) a failed probe re-initializes
        # from at once.
        self._recent_imgs: collections.deque = collections.deque(maxlen=10)

    def _collapse_retry(self, ts_rel: float) -> None:
        """Scale-collapse probe failed: discard the young map, seed the
        init frame cache from the recent raw images and re-attempt the
        initialization at once (the session epoch is kept)."""
        imgs = list(self._recent_imgs)
        t0 = self._t0
        self.reset()
        self._t0 = t0
        self._had_collapse_reset = True
        if len(imgs) < 2:
            return
        for tsd, g in imgs[:-1]:
            self._init_frames.append((float(tsd), self._make_frame(g, tsd)))
        ts_cur, img_cur = imgs[-1]
        cur = self._make_frame(img_cur, ts_cur)
        with profiling.span("slam.init"):
            self._try_initialize(cur, float(ts_cur))

    def _init_par_scale(self) -> float:
        """Parallax-floor multiplier for init acceptance: flat for the
        first two collapse resets, one boost step from the third."""
        boost = self.cfg.tracking.init_collapse_par_boost
        return float(boost) ** min(max(self._collapse_resets - 2, 0), 1)

    # ------------------------------------------------------------------
    # Device steps

    def _make_frame(self, img, ts) -> Frame:
        self.frames_extracted += 1
        with profiling.span("slam.frontend"):
            return make_frame(img, ts, self.cfg.orb, self.cfg.camera,
                              device=self.device)

    def _init_multi(self, refs: Frame, cur: Frame, par_scale: float):
        """Score the current frame against a batch of references in one
        batched two_view_init. Returns (results (K, …), probes (K, 7):
        [ok, score, n_good, t_dir(3), |t|])."""
        res = two_view_init(
            refs.uv_und, refs.feat.desc, refs.feat.valid, refs.feat.angle,
            cur.uv_und, cur.feat.desc, cur.feat.valid, cur.feat.angle,
            self._K, self.cfg.tracking, generator=self._gen,
            par_scale=torch.full((refs.uv_und.shape[0],), par_scale,
                                 device=self.device))
        t_norm = torch.clamp(torch.linalg.norm(res.t, dim=-1), min=1e-12)
        probes = torch.cat([
            torch.stack([res.ok.to(torch.float32), res.score,
                         res.n_good.to(torch.float32)], -1),
            res.t / t_norm[:, None], t_norm[:, None]], -1)
        return res, probes

    def _bootstrap_map(self, m: MapState, fa: Frame, fb: Frame,
                       init_res: InitResult) -> MapState:
        return bootstrap_map(m, fa, fb, init_res, self._K, self.cfg)

    def _backfill_step(self, m: MapState, R_cur, t_cur, alphas,
                       frames: List[Frame]) -> torch.Tensor:
        """Track each cached frame between the committed pair against
        the fresh map from the geodesic interpolation of the pair's
        relative pose at its time fraction ``alphas`` (B,). Returns the
        (B, 8) bundle [twc(3), quat(4), n_inliers], read by the host in
        one copy."""
        cfg = self.cfg
        orb, tr, cam = cfg.orb, cfg.tracking, cfg.camera
        phi = so3_log(R_cur)
        rows = []
        for alpha, frame in zip(alphas, frames):
            with profiling.span("slam.tracking"):
                r = track_frame(
                    so3_exp(alpha * phi), alpha * t_cur, m.lm_pos,
                    m.lm_desc, m.lm_valid, frame.uv_und, frame.feat.desc,
                    frame.feat.valid, frame.feat.octave, cam.fx, cam.fy,
                    cam.cx, cam.cy, cam.width, cam.height, tr,
                    scale_factor=orb.scale_factor)
            Rwc, twc = se3_inverse(r.R, r.t)
            rows.append(torch.cat([twc, quat_from_rotmat(Rwc),
                                   r.n_inliers.to(torch.float32)[None]]))
        return torch.stack(rows)

    def _frame_step(self, m: MapState, st: LoopState, img, ts,
                    chain_break=False):
        """The per-frame path: damped velocity prediction, make_frame,
        track_frame, landmark stats, the keyframe decision, insertion +
        triangulation + the insert BA burst, or one amortized BA slice.
        Returns (map, loop_state, summary (12,) f32)."""
        cfg = self.cfg
        orb, tr, cam = cfg.orb, cfg.tracking, cfg.camera
        MK, W = cfg.map.max_keyframes, cfg.map.ba_window
        dev = self.device

        R2i, t2i = se3_inverse(st.R2, st.t2)
        Rv, tv = se3_compose(st.R, st.t, R2i, t2i)
        Rv, tv = se3_exp(se3_log(Rv, tv) * tr.velocity_damping)
        Rp, tp = se3_compose(Rv, tv, st.R, st.t)
        R_pred = torch.where(st.has_vel, Rp, st.R)
        t_pred = torch.where(st.has_vel, tp, st.t)

        frame = self._make_frame(img, ts)
        with profiling.span("slam.tracking"):
            res = track_frame(
                R_pred, t_pred, m.lm_pos, m.lm_desc, m.lm_valid,
                frame.uv_und, frame.feat.desc, frame.feat.valid,
                frame.feat.octave, cam.fx, cam.fy, cam.cx, cam.cy,
                cam.width, cam.height, tr, scale_factor=orb.scale_factor,
                search_radius=tr.search_radius_px, R_rescue=st.R,
                t_rescue=st.t, lm_normal=m.lm_normal,
                lm_dist_min=m.lm_dist_min, lm_dist_max=m.lm_dist_max,
                n_levels=orb.n_levels)
        m = update_landmark_stats(m, res.in_view, res.inlier)

        # --- keyframe decision (NeedNewKeyFrame) -----------------------
        fs = st.frames_since_kf + 1
        ok = res.n_inliers >= tr.min_track_matches
        if tr.kf_ref_map:
            ML = m.max_landmarks
            newest = torch.clamp(m.n_kf - 1, 0, MK - 1).long()
            obs_row = m.kf_obs_lm[newest]
            mature = m.lm_valid & (m.lm_vote_count
                                   >= torch.clamp(m.n_kf, max=3))
            ref = ((obs_row >= 0)
                   & mature[torch.clamp(obs_row, 0, ML - 1).long()]
                   ).sum(dtype=torch.int32)
        else:
            ref = st.inliers_at_kf
        weak_now = res.n_inliers < torch.tensor(
            tr.kf_tracked_ratio, dtype=torch.float32, device=dev) \
            * torch.clamp(ref, min=1).to(torch.float32)
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        weak_run = torch.where(weak_now, st.weak_run + 1, zero_i)
        weak = weak_run >= tr.kf_weak_frames
        stale = fs >= tr.kf_max_interval
        capacity = m.n_kf < MK - 1
        need_kf = ok & capacity & (fs >= tr.kf_min_interval) & (weak | stale)
        kf_slot = torch.where(need_kf, m.n_kf, torch.full_like(m.n_kf, -1))
        profiling.count("sync.need_kf")
        insert = bool(need_kf)

        win = st.ba_window
        if insert:
            with profiling.span("slam.mapping"):
                m, _kf_id, _n_new = insert_keyframe_with_triangulation(
                    m, res.R, res.t, frame, res.matches.idx,
                    res.matches.valid & res.inlier, self._K, tr,
                    chain_break=chain_break, scale_factor=orb.scale_factor,
                    n_levels=orb.n_levels,
                    triangulate_backs=tr.triangulate_backs)
                win = covis_window_ids(m, W)[0]
            profiling.count("keyframes")
            profiling.count("sync.n_kf")

        # --- amortized BA (the LocalMapping time slice) ---------------
        K_INS = tr.kf_insert_ba_iters
        ba_it = torch.where(need_kf, torch.full_like(st.ba_it, K_INS),
                            st.ba_it)
        run_ba = (~need_kf) & (m.n_kf >= 3) & (ba_it < tr.ba_slice_max)
        lam = torch.clamp(
            tr.ba_slice_damping * (0.5 ** ba_it.to(torch.float32)),
            min=tr.ba_slice_damping * 1e-2)
        if insert and int(m.n_kf) >= 3:
            with profiling.span("slam.mapping"):
                m = local_bundle_adjustment(
                    m, self._K, cfg.map, iters=K_INS,
                    damping=tr.ba_slice_damping, window_ids=win, prune=True)
            profiling.count("ba_slices")
        else:
            profiling.count("sync.run_ba")
            if bool(run_ba):
                with profiling.span("slam.mapping"):
                    m = local_bundle_adjustment(
                        m, self._K, cfg.map, iters=1, damping=lam,
                        window_ids=win, prune=ba_it >= tr.ba_prune_after)
                profiling.count("ba_slices")
        ba_it = ba_it + run_ba.to(torch.int32)

        st_new = LoopState(
            R=res.R, t=res.t, R2=st.R, t2=st.t,
            has_vel=torch.tensor(True, device=dev),
            frames_since_kf=torch.where(need_kf, zero_i, fs),
            inliers_at_kf=torch.where(need_kf, res.n_inliers,
                                      st.inliers_at_kf),
            ba_it=ba_it, ba_window=win,
            weak_run=torch.where(need_kf, zero_i, weak_run))
        Rwc, twc = se3_inverse(res.R, res.t)
        summary = torch.cat([
            res.n_inliers.reshape(1).to(torch.float32), twc,
            quat_from_rotmat(Rwc), need_kf.reshape(1).to(torch.float32),
            m.n_kf.reshape(1).to(torch.float32),
            kf_slot.reshape(1).to(torch.float32),
            m.n_landmarks().reshape(1).to(torch.float32)])
        return m, st_new, summary

    def _reloc_step(self, m: MapState, frame: Frame, sample_idx=None):
        """Relocalization: the top-3 retrieval candidates each re-track
        the frame from their keyframe pose (wide window, no rescue),
        beside a prior-free PnP RANSAC; the most inliers wins.
        ``sample_idx`` (n_hyp, 6) injects the RANSAC minimal sets.
        Returns (RelocOut, the top retrieval score)."""
        cfg = self.cfg
        orb, tr, cam = cfg.orb, cfg.tracking, cfg.camera
        sig = frame_signature(frame.feat.desc, frame.feat.valid)
        idf = idf_weights(m.kf_signature, m.kf_valid)
        scores = torch.where(
            m.kf_valid, retrieval_scores(m.kf_signature, sig, idf=idf),
            torch.full_like(m.kf_signature[:, 0], -1.0))
        _, top = stable_topk(scores, 3)
        cands = [track_frame(
            m.kf_R[c], m.kf_t[c], m.lm_pos, m.lm_desc, m.lm_valid,
            frame.uv_und, frame.feat.desc, frame.feat.valid,
            frame.feat.octave, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height, tr, scale_factor=orb.scale_factor,
            search_radius=64.0, enable_rescue=False) for c in top]
        nc = torch.stack([r.n_inliers for r in cands])
        profiling.count("sync.reloc_best")
        best = cands[int(torch.argmax(nc))]
        pnp = relocalize(m.lm_pos, m.lm_desc, m.lm_valid, frame.uv_und,
                         frame.feat.desc, frame.feat.valid, self._K, tr,
                         generator=self._gen, sample_idx=sample_idx)
        use_pnp = pnp.ok & (pnp.n_inliers > best.n_inliers)
        return RelocOut(R=torch.where(use_pnp, pnp.R, best.R),
                        t=torch.where(use_pnp, pnp.t, best.t),
                        n_inliers=torch.where(use_pnp, pnp.n_inliers,
                                              best.n_inliers),
                        use_pnp=use_pnp), scores[top[0]]

    def _maintain_step(self, m: MapState) -> MapState:
        """Keyframe-rate maintenance: zero-obs landmark pruning and
        redundant keyframe culling."""
        m = prune_zero_obs_landmarks(m)
        m, _ = cull_redundant_keyframes(m, max_cull=2)
        return m

    @staticmethod
    def _compact_step(m: MapState):
        """Pack the keyframe table. Returns (map, n_valid)."""
        return compact_keyframes(m)

    @staticmethod
    def _forced_cull_step(m: MapState):
        """Capacity-pressure cull: when the table fills and no keyframe
        crossed the redundancy bar, drop the single most redundant
        unprotected keyframe. Returns (map, n_culled)."""
        return cull_redundant_keyframes(m, redundancy_th=0.0, keep_latest=3,
                                        max_cull=1)

    def _covis_window(self, m: MapState) -> torch.Tensor:
        return covis_window_ids(m, self.cfg.map.ba_window)[0]

    @staticmethod
    def _atlas_cand(frozen: MapState, sig):
        """The frozen map's best keyframe for a signature: (kf, score)."""
        return best_cross_map_candidate(frozen, sig)

    def _atlas_noise(self, m: MapState) -> torch.Tensor:
        """One (n_hyp, N) draw of Gumbel noise for ``_atlas_sim3``, from
        the System's CPU generator."""
        return gumbel_noise(self._gen, (N_HYP, m.n_keypoints), self.device)

    def _atlas_sim3(self, active: MapState, frozen: MapState, active_kf,
                    frozen_kf, noise):
        """The cross-map Sim(3) between a keyframe of each map."""
        tr = self.cfg.tracking
        return cross_map_sim3(active, frozen, active_kf, frozen_kf, noise,
                              tr, min_matches=tr.loop_min_matches)

    @staticmethod
    def _atlas_weld(active: MapState, frozen: MapState, s, R, t):
        """Import the frozen map: (map, n_kf_imported, n_lm_imported)."""
        return weld_maps(active, frozen, s, R, t)

    def _newest_kf_delta(self, m_pre: MapState, m_post: MapState):
        cur = torch.clamp(m_pre.n_kf - 1, 0, m_pre.max_keyframes - 1).long()
        Rb, tb = m_pre.kf_R[cur], m_pre.kf_t[cur]
        dR = m_post.kf_R[cur] @ Rb.T
        return dR, m_post.kf_t[cur] - dR @ tb

    def _polish_slice(self, m: MapState, lam, prune, wcfg, window_ids=None,
                      n_fixed: int = 2, renorm_baseline: bool = False):
        """One wide/young BA iteration, the newest keyframe's delta and
        the on-device flag of a correction large enough to rebase the
        pose chain (angle or centre move against the last baseline).
        ``renorm_baseline`` restores the KF0->KF1 baseline about KF0's
        centre after a one-anchor slice. Returns (map, dR, dt, big)."""
        tr = self.cfg.tracking
        MK = m.max_keyframes
        m2 = local_bundle_adjustment(
            m, self._K, wcfg, iters=1, damping=lam, prune=prune,
            window_ids=window_ids, n_fixed=n_fixed)

        def center(mm, i):
            return -(mm.kf_R[i].T @ mm.kf_t[i][:, None])[:, 0]

        if renorm_baseline:
            C0 = center(m2, 0)
            b_pre = torch.linalg.norm(center(m, 1) - center(m, 0))
            b_post = torch.clamp(torch.linalg.norm(center(m2, 1) - C0),
                                 min=1e-9)
            s = b_pre / b_post
            C_all = -torch.einsum('kij,kj->ki', m2.kf_R.transpose(1, 2),
                                  m2.kf_t)
            kf_t_new = -torch.einsum('kij,kj->ki', m2.kf_R,
                                     C0 + s * (C_all - C0))
            m2 = m2.replace(
                kf_t=torch.where(m2.kf_valid[:, None], kf_t_new, m2.kf_t),
                lm_pos=torch.where(m2.lm_valid[:, None],
                                   C0 + s * (m2.lm_pos - C0), m2.lm_pos),
                lm_dist_min=m2.lm_dist_min * s,
                lm_dist_max=m2.lm_dist_max * s)
        dR, dt = self._newest_kf_delta(m, m2)
        cur = torch.clamp(m.n_kf - 1, 0, MK - 1).long()
        prev = torch.clamp(m.n_kf - 2, 0, MK - 1).long()
        Cb, Ca, Cp = center(m, cur), center(m2, cur), center(m, prev)
        base = torch.clamp(torch.linalg.norm(Cb - Cp), min=1e-6)
        ang = torch.arccos(torch.clamp((torch.trace(dR) - 1.0) / 2.0,
                                       -1.0, 1.0))
        big = (ang > np.deg2rad(tr.polish_rebase_min_deg)) \
            | (torch.linalg.norm(Ca - Cb)
               > tr.polish_rebase_baseline_frac * base)
        return m2, dR, dt, big

    def _wide_slice(self, m: MapState, lam, prune):
        """Wide polish slice over the hybrid recent + covisible window
        (or the recency window, per ``wide_ba_covis_window``)."""
        W = self._wide_cfg.ba_window
        ids = (wide_window_ids(m, W)[0]
               if self.cfg.tracking.wide_ba_covis_window else None)
        return self._polish_slice(m, lam, prune, self._wide_cfg,
                                  window_ids=ids)

    def _young_slice(self, m: MapState, lam, prune):
        """Young-map re-solve: a one-anchor recency-window slice with
        the baseline renormalized."""
        return self._polish_slice(m, lam, prune, self._wide_cfg,
                                  n_fixed=1, renorm_baseline=True)

    def _global_slice(self, m: MapState, lam, prune):
        """Global polish slice over every keyframe slot (after a loop
        closure)."""
        return self._polish_slice(m, lam, prune, self._glob_cfg)

    def _loop_candidate(self, m: MapState, kf_id):
        """The top-3 retrieval candidates of keyframe ``kf_id`` at least
        ``loop_min_gap_kf`` slots away. Returns (cands, scores)."""
        return loop_candidates(m, kf_id, self.cfg.tracking.loop_min_gap_kf,
                               k=3)

    def _loop_noise(self, m: MapState) -> torch.Tensor:
        """One draw of Gumbel noise for ``_loop_sim3``: a (n_hyp, N)
        block per candidate, from the System's CPU generator."""
        return gumbel_noise(self._gen, (3, N_HYP, m.n_keypoints),
                            self.device)

    def _loop_sim3(self, m: MapState, kf_id, cands, noise):
        """Sim(3)-verify the candidates; returns (LoopSim3 of the
        winner, its candidate id)."""
        tr = self.cfg.tracking
        return compute_loop_sim3_multi(m, kf_id, cands, noise, tr,
                                       min_matches=tr.loop_min_matches)

    def _loop_apply(self, m: MapState, kf_id, cand_id, loop):
        """The pose-graph correction of a verified loop, the newest
        keyframe's delta (for the chain rebase) and the map's median
        reprojection error before and after it (for the sanity gate).
        Returns (map, dR, dt, med_before, med_after)."""
        cam = self.cfg.camera
        med_before = map_reprojection_median(m, cam.fx, cam.fy, cam.cx,
                                             cam.cy)
        m2 = apply_loop_correction(
            m, kf_id, cand_id, loop,
            covis_max_gap=self.cfg.tracking.loop_covis_max_gap)
        med_after = map_reprojection_median(m2, cam.fx, cam.fy, cam.cx,
                                            cam.cy)
        dR, dt = self._newest_kf_delta(m, m2)
        return m2, dR, dt, med_before, med_after

    @staticmethod
    def _rebase_st(st: LoopState, dR, dt) -> LoopState:
        return st.replace(R=dR @ st.R, t=dR @ st.t + dt,
                          R2=dR @ st.R2, t2=dR @ st.t2 + dt)

    def _rebase_st_cond(self, st: LoopState, dR, dt, big) -> LoopState:
        """``_rebase_st`` where the on-device flag ``big`` is set, the
        carried state unchanged elsewhere (no host read)."""
        st2 = self._rebase_st(st, dR, dt)
        return LoopState(**{
            f.name: torch.where(big, getattr(st2, f.name), getattr(st, f.name))
            for f in dataclasses.fields(LoopState)})

    # ------------------------------------------------------------------
    # State machine

    def track_monocular(self, gray, timestamp: float) -> TrackOutput:
        """gray: (H, W) uint8 or float image. Returns the pose as Twc
        (world-from-camera). Device timestamps are session-relative."""
        self.calls += 1
        with profiling.span("slam.frame", self.calls - 1):
            profiling.count("frames")
            if self._t0 is None:
                self._t0 = float(timestamp)
            ts_dev = float(timestamp) - self._t0
            self._recent_imgs.append((ts_dev, gray))
            if self.state in (TRACKING_OK, TRACKING_RECENTLY_LOST):
                return self._track_pipelined(gray, timestamp, ts_dev)

            self._flush_pipeline()
            if self.state in (TRACKING_NO_IMAGES_YET,
                              TRACKING_NOT_INITIALIZED):
                frame = self._make_frame(gray, ts_dev)
                with profiling.span("slam.init"):
                    self._try_initialize(frame, ts_dev)
            elif self.state == TRACKING_LOST:
                frame = self._make_frame(gray, ts_dev)
                with profiling.span("slam.reloc"):
                    self._relocalize(frame, timestamp)
            if self.state == TRACKING_OK:
                pos, quat = self._twc()
                if self._collapse_active:
                    # A commit under a pending collapse probe: hold the
                    # pose and keep reporting "initializing".
                    self._held_outputs.append((timestamp, pos, quat))
                    out = TrackOutput(TRACKING_NOT_INITIALIZED, None, None,
                                      self._last_inliers, timestamp)
                    self._last_out = out
                    return out
                self._trajectory.append((timestamp, pos, quat))
                bf = tuple(self._backfill_pending)
                self._backfill_pending = []
                out = TrackOutput(TRACKING_OK, pos, quat, self._last_inliers,
                                  timestamp, backfill=bf)
                self._last_out = out
                return out
            return TrackOutput(self.state, None, None, 0, timestamp)

    def _commit_init(self, ref_frame: Frame, cur_frame: Frame,
                     res: InitResult, timestamp: float,
                     n_good=None) -> None:
        tr = self.cfg.tracking
        self.map = self._bootstrap_map(self.map, ref_frame, cur_frame, res)
        self._st = self._fresh_loop_state().replace(
            R=res.R, t=res.t, R2=res.R, t2=res.t,
            inliers_at_kf=res.n_good.to(torch.int32))
        self.state = TRACKING_OK
        self._n_kf_host = 2
        self._slots_used = 2
        self._last_inliers = int(n_good if n_good is not None
                                 else res.n_good)
        self._init_best = None
        self._init_prev_cands = None
        self._init_tdir_rejects = 0
        cached = list(self._init_frames)     # for the backfill, below
        self._init_frames.clear()
        self.init_commit_ts = timestamp
        t0 = self._t0 or 0.0
        ts_ref = t0 + float(ref_frame.timestamp)
        self._kf_trajectory.append(
            (ts_ref, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])))
        ts_cur = t0 + float(cur_frame.timestamp)
        profiling.count("sync.commit_ts", 2)
        Rwc, twc = se3_inverse(res.R, res.t)
        twc_np = twc.cpu().numpy()
        self._kf_trajectory.append(
            (ts_cur, twc_np, quat_from_rotmat(Rwc).cpu().numpy()))
        profiling.count("sync.commit_pose", 2)
        profiling.count("keyframes", 2)
        # Arm the young-map scale-collapse probe: the init pair's own
        # baseline velocity is the yardstick.
        dt_init = max(ts_cur - ts_ref, 1.0 / 120.0)
        self._init_v = float(np.linalg.norm(twc_np)) / dt_init
        self._collapse_trace = []
        self._collapse_active = (
            tr.init_collapse_frac > 0.0
            and self._collapse_resets < tr.init_collapse_max_resets)

        # Trajectory backfill: the cached frames strictly between the
        # committed pair, tracked against the fresh map; their poses
        # ride the probe hold like the commit frame's own.
        ts_ref_rel, ts_cur_rel = ts_ref - t0, ts_cur - t0
        between = [(tf, f) for tf, f in cached
                   if ts_ref_rel < tf < ts_cur_rel][-self._n_backfill:]
        if tr.init_backfill and between:
            span = max(ts_cur_rel - ts_ref_rel, 1e-6)
            alphas = torch.tensor([(tf - ts_ref_rel) / span
                                   for tf, _ in between],
                                  dtype=torch.float32, device=self.device)
            bundle = self._backfill_step(
                self.map, res.R, res.t, alphas,
                [f for _, f in between]).cpu().numpy()
            profiling.count("sync.backfill")
            sink = (self._held_outputs if self._collapse_active
                    else self._backfill_pending)
            for k, (tf, _f) in enumerate(between):
                if bundle[k, 7] >= tr.min_track_matches:
                    sink.append((t0 + tf, bundle[k, 0:3].copy(),
                                 bundle[k, 3:7].copy()))
            if not self._collapse_active:
                self._trajectory.extend(self._backfill_pending)

    def _try_initialize(self, frame: Frame, timestamp: float) -> None:
        """Multi-reference init: score the frame against the cached
        references at ``init_ref_gaps`` in one batched call and commit a
        pair certified by translation-direction and speed agreement (or
        the best acceptable pair after ``init_tdir_max_rejects``)."""
        tr = self.cfg.tracking
        cache = self._init_frames
        cache.append((timestamp, frame))
        self.state = TRACKING_NOT_INITIALIZED
        n = len(cache) - 1
        if n < 1:
            return
        idxs: List[int] = []
        for g in tr.init_ref_gaps:
            j = max(n - g, 0)
            if j not in idxs:
                idxs.append(j)
        n_uniq = len(idxs)
        while len(idxs) < self._n_init_refs:
            idxs.append(idxs[0])
        refs = [cache[j] for j in idxs]
        res, probes = self._init_multi(_stack_frames([r[1] for r in refs]),
                                       frame, self._init_par_scale())
        self.init_attempts += 1
        p = probes.cpu().numpy().reshape(self._n_init_refs, 7)
        profiling.count("sync.init_probes")

        cands = []
        for i in range(n_uniq):
            if p[i, 0] > 0.5:
                dt = max(timestamp - refs[i][0], 1.0 / 120.0)
                cands.append((float(p[i, 1]), i, p[i, 3:6].copy(),
                              float(p[i, 2]), float(p[i, 6]) / dt))
        if not cands:
            self._init_prev_cands = None
            return

        top = max(cands, key=lambda c: c[0])
        if self._init_best is None or top[0] > self._init_best[0]:
            self._init_best = (top[0], _index_result(res, top[1]),
                               refs[top[1]][1], frame, timestamp, top[3])

        certified = None
        if tr.init_tdir_max_deg <= 0.0:
            certified = top
        else:
            cosmax = float(np.cos(np.radians(tr.init_tdir_max_deg)))

            def agree(ca_dir, ca_v, cb_dir, cb_v):
                if float(np.dot(ca_dir, cb_dir)) < cosmax:
                    return False
                if tr.init_vel_band <= 0:
                    return True
                hi, lo = max(ca_v, cb_v), max(min(ca_v, cb_v), 1e-12)
                return hi / lo <= tr.init_vel_band

            for a in range(len(cands)):
                for b in range(a + 1, len(cands)):
                    if agree(cands[a][2], cands[a][4], cands[b][2],
                             cands[b][4]):
                        c = max(cands[a], cands[b], key=lambda c: c[0])
                        if certified is None or c[0] > certified[0]:
                            certified = c
            prev = self._init_prev_cands
            if certified is None and prev is not None and (
                    timestamp - prev[0] <= tr.init_tdir_window_s
                    or self.init_attempts - prev[1] == 1):
                for c in cands:
                    for d_dir, d_v in prev[2]:
                        if agree(c[2], c[4], d_dir, d_v) and (
                                certified is None or c[0] > certified[0]):
                            certified = c

        if certified is not None:
            with profiling.span("slam.init"):
                self._commit_init(refs[certified[1]][1], frame,
                                  _index_result(res, certified[1]),
                                  timestamp, n_good=certified[3])
            return
        self._init_tdir_rejects += 1
        if self._init_tdir_rejects >= tr.init_tdir_max_rejects:
            best = self._init_best
            with profiling.span("slam.init"):
                self._commit_init(best[2], best[3], best[1], best[4],
                                  n_good=best[5])
            return
        self._init_prev_cands = (timestamp, self.init_attempts,
                                 [(c[2], c[4]) for c in cands])

    def _track_pipelined(self, gray, timestamp: float,
                         ts_dev: float) -> TrackOutput:
        """Run one queued polish slice, then this frame's step; act on
        the summary ``pipeline_depth`` frames late, as the JAX System
        does."""
        if self._polish_queue:
            kind, lam, prune = self._polish_queue.pop(0)
            step = {"wide": self._wide_slice, "young": self._young_slice,
                    "global": self._global_slice}[kind]
            with profiling.span("slam.polish"):
                self.map, dR, dt, big = step(self.map, lam, prune)
                self.polish_slices_run[kind] += 1
                # Rebase the speculative chain only on a large wide or
                # young correction: global slices follow a loop apply
                # that rebased it already, and rebasing again
                # double-corrects.
                if kind != "global":
                    self._st = self._rebase_st_cond(self._st, dR, dt, big)
            profiling.count("ba_slices")

        st_prev = self._st
        m2, st2, summary = self._frame_step(
            self.map, self._st, gray, ts_dev,
            chain_break=self._reloc_boundary_next_kf)
        self._pending.append(dict(ts=timestamp, st_prev=st_prev,
                                  summary=summary, frame=self.calls - 1))
        self.map, self._st = m2, st2
        depth = self.cfg.tracking.pipeline_depth
        while len(self._pending) > depth:
            if self.state not in (TRACKING_OK, TRACKING_RECENTLY_LOST):
                break
            with profiling.span("slam.lagged", self._pending[0]["frame"]):
                self._ready.append(self._process_lagged())
        if self._ready:
            return self._ready.pop(0)
        # Pipeline warming up: repeat the last output with its own
        # timestamp but without its backfill (late poses are one-shot).
        if self._last_out is not None:
            if self._last_out.backfill:
                self._last_out = self._last_out._replace(backfill=())
            return self._last_out
        # No output yet this session (a collapse-retry commit): never
        # report TRACKING_OK without a pose.
        st = (TRACKING_NOT_INITIALIZED if self.state == TRACKING_OK
              else self.state)
        return TrackOutput(st, None, None, 0, timestamp)

    def _process_lagged(self) -> TrackOutput:
        ent = self._pending.pop(0)
        tr = self.cfg.tracking
        s = ent["summary"].cpu().numpy()
        profiling.count("sync.lagged_summary")
        n_inl = int(s[S_INLIERS])
        profiling.count("inliers", n_inl)
        pos, quat = s[S_POS:S_POS + 3], s[S_QUAT:S_QUAT + 4]
        n_kf = int(s[S_NKF])
        ts = ent["ts"]

        if n_inl < tr.min_track_matches:
            if n_kf <= 5:
                # Young map: the two-view geometry was bad; re-init.
                self.reset()
                return TrackOutput(self.state, None, None, 0, ts)
            self._st = ent["st_prev"].replace(
                has_vel=torch.tensor(False, device=self.device))
            self._pending.clear()
            self._lost_frames += 1
            self.state = (TRACKING_RECENTLY_LOST if self._lost_frames <= 3
                          else TRACKING_LOST)
            out = TrackOutput(self.state, None, None, 0, ts)
            self._last_out = out
            return out

        self._last_inliers = n_inl
        self._lost_frames = 0
        self.state = TRACKING_OK

        # Young-map scale-collapse probe, one-shot over the first full
        # window after the commit: the streamed velocity against the
        # init pair's. On a collapse the young map is discarded and the
        # init retried; while it is pending, poses are held.
        if self._collapse_active and self._init_v:
            ts_rel = ts - (self._t0 or 0.0)
            age = ts_rel - (self.init_commit_ts or 0.0)
            trc = self._collapse_trace
            trc.append((ts_rel, np.asarray(pos, float)))
            if age > tr.init_collapse_horizon_s:
                self._collapse_active = False
            else:
                win = (tr.init_collapse_retry_window_s
                       if self._collapse_resets > 0
                       else tr.init_collapse_window_s)
                span = ts_rel - trc[0][0]
                if span >= win:
                    v_est = float(np.linalg.norm(
                        trc[-1][1] - trc[0][1])) / span
                    ratio = v_est / max(self._init_v, 1e-9)
                    self._collapse_active = False
                    self.collapse_probes.append(
                        (self.init_commit_ts, ts_rel, ratio,
                         ratio >= tr.init_collapse_frac))
                    if ratio < tr.init_collapse_frac:
                        self._collapse_resets += 1
                        self._collapse_retry(ts_rel)
                        # The new map's probe is pending even when the
                        # retry committed at once.
                        return TrackOutput(TRACKING_NOT_INITIALIZED,
                                           None, None, 0, ts)
            if not self._collapse_active:
                # Passed (or expired): the held poses are real; the
                # reset budget re-arms.
                self._collapse_resets = 0
                self._trajectory.extend(self._held_outputs)
                self._backfill_pending.extend(self._held_outputs)
                self._held_outputs = []

        with profiling.span("slam.loop"):
            self._maybe_close_loop()
            self._maybe_weld()
        if s[S_KF] > 0.5:
            self._on_keyframe_inserted(int(s[S_SLOT]), n_kf, ts, pos, quat)
        with profiling.span("slam.loop"):
            self._maybe_compact(n_kf)

        if self._collapse_active:
            self._held_outputs.append((ts, np.asarray(pos),
                                       np.asarray(quat)))
            out = TrackOutput(TRACKING_NOT_INITIALIZED, None, None, n_inl,
                              ts)
            self._last_out = out
            return out

        self._trajectory.append((ts, pos, quat))
        bf = tuple(self._backfill_pending)
        self._backfill_pending = []
        out = TrackOutput(TRACKING_OK, pos, quat, n_inl, ts,
                          n_landmarks=int(s[S_NLM]), backfill=bf)
        self._last_out = out
        return out

    def _flush_pipeline(self, final: bool = False) -> List[TrackOutput]:
        """Drain in-flight frames (state transitions, shutdown). With
        ``final`` (session end), also flush the poses a pending
        collapse probe holds: the probe never failed."""
        outs = list(self._ready)
        self._ready.clear()
        while self._pending:
            if self.state not in (TRACKING_OK, TRACKING_RECENTLY_LOST):
                self._pending.clear()
                break
            with profiling.span("slam.lagged", self._pending[0]["frame"]):
                outs.append(self._process_lagged())
        # An applied closure must not outlive the pipeline unjudged.
        self._resolve_loop_sanity()
        if final and self._held_outputs:
            bf = tuple(self._held_outputs)
            self._trajectory.extend(self._held_outputs)
            self._held_outputs = []
            outs.append(TrackOutput(TRACKING_NOT_INITIALIZED, None, None,
                                    0, bf[-1][0], backfill=bf))
        return outs

    def _relocalize(self, frame: Frame, timestamp: float) -> None:
        """Pose recovery against the map. On success tracking resumes
        from the recovered pose; after ``atlas_reloc_patience`` failures
        on a map of ``atlas_min_kf`` keyframes it is frozen."""
        tr = self.cfg.tracking
        res, _score = self._reloc_step(self.map, frame)
        n = int(res.n_inliers)
        self.last_reloc = dict(ok=n >= tr.reloc_min_matches, inliers=n,
                               branch="pnp" if bool(res.use_pnp)
                               else "retrieval")
        profiling.count("sync.reloc", 2)
        if n >= tr.reloc_min_matches:
            self._st = self._st.replace(
                R=res.R, t=res.t, R2=res.R, t2=res.t,
                has_vel=torch.tensor(False, device=self.device))
            self.state = TRACKING_OK
            self._last_inliers = n
            self._lost_frames = 0
            self._reloc_failures = 0
            self._reloc_boundary_next_kf = True
            return
        self._reloc_failures += 1
        if (self._reloc_failures >= tr.atlas_reloc_patience
                and self._slots_used >= tr.atlas_min_kf):
            self._freeze_to_atlas()

    def _freeze_to_atlas(self) -> None:
        """Park the active map in the atlas (the oldest dropped beyond
        ``max_atlas_maps``) and start a fresh one, keeping the session's
        trajectories, epoch, RANSAC stream, init counters and loop
        attempts (an applied closure awaiting its verdict is dropped
        unjudged, as in the reference)."""
        self.atlas.append(self.map)
        if len(self.atlas) > self.cfg.tracking.max_atlas_maps:
            self.atlas.pop(0)
        traj, kf_traj = self._trajectory, self._kf_trajectory
        gen_state = self._gen.get_state()
        t0 = self._t0
        n_init, ts_init = self.init_attempts, self.init_commit_ts
        attempts = self.loop_attempts
        self.reset()
        self._trajectory, self._kf_trajectory = traj, kf_traj
        self._gen.set_state(gen_state)
        self.loop_attempts = attempts
        self.init_attempts, self.init_commit_ts = n_init, ts_init
        self._t0 = t0

    def _maybe_close_loop(self) -> None:
        """One loop phase per drained frame. First the sanity verdict of
        a closure applied on the previous one. Phase 1 reads the probe's
        top score and candidate: outside (loop_score_min, loop_score_max)
        or before loop_consistency_kf consecutive probes agree on a
        region, the probe ends; else the candidates retrieved at
        insertion are Sim(3)-verified on the current map, with one draw
        from the generator. Phase 2 reads the verdict: a verified loop's
        correction is applied at once and the chain rebased by the
        newest keyframe's delta; its sanity is judged on the next
        drained frame."""
        self._resolve_loop_sanity()
        p = self._pending_loop
        if p is None:
            return
        tr = self.cfg.tracking
        kf_slot = p["kf_slot"]

        if "loop" not in p:                     # phase 1: the score
            score = float(p["scores"][0])
            cand_val = int(p["cands"][0])
            profiling.count("sync.loop_probe", 2)
            # Saturated scores mean near-duplicate keyframes (a map
            # folded onto itself), not a revisit.
            if score <= tr.loop_score_min or score >= tr.loop_score_max:
                self._pending_loop = None
                self._loop_consistency = None
                self.loop_attempts.append((kf_slot, cand_val, score, None))
                return
            prev = self._loop_consistency
            if prev is not None and abs(cand_val - prev[0]) \
                    <= tr.loop_consistency_radius:
                run = prev[1] + 1
            else:
                run = 1
            self._loop_consistency = (cand_val, run)
            if run < tr.loop_consistency_kf:
                self._pending_loop = None
                self.loop_attempts.append((kf_slot, cand_val, score, None))
                return
            loop, cand_sel = self._loop_sim3(self.map, kf_slot, p["cands"],
                                             self._loop_noise(self.map))
            self._pending_loop = dict(kf_slot=kf_slot, cand_top=cand_val,
                                      score=score, loop=loop,
                                      cand_sel=cand_sel)
            return

        self._pending_loop = None               # phase 2: the verdict
        profiling.count("sync.loop_verdict")
        if not bool(p["loop"].ok):
            self.loop_attempts.append((kf_slot, p["cand_top"], p["score"],
                                       False, None))
            return
        m_pre = self.map
        m2, dR, dt, med_b, med_a = self._loop_apply(
            self.map, kf_slot, p["cand_sel"], p["loop"])
        self.map = m2
        self._st = self._rebase_st(self._st, dR, dt)
        self._pending_loop_sanity = dict(
            kf_slot=kf_slot, cand_sel=p["cand_sel"], cand_top=p["cand_top"],
            score=p["score"], m_pre=m_pre, dR=dR, dt=dt, med_b=med_b,
            med_a=med_a)

    def _resolve_loop_sanity(self) -> None:
        """Judge an applied closure: its median reprojection error must
        stay within max(loop_sanity_px, loop_sanity_factor x the median
        before it). A sane closure queues the global polish slices and
        arms the cooldown; otherwise the pre-apply map is restored and
        the chain inverse-rebased (nothing else is restored, as in the
        reference)."""
        p = self._pending_loop_sanity
        if p is None:
            return
        tr = self.cfg.tracking
        self._pending_loop_sanity = None
        med_b, med_a = float(p["med_b"]), float(p["med_a"])
        profiling.count("sync.loop_sanity", 2)
        sane = (not np.isfinite(med_a)) or med_a <= max(
            tr.loop_sanity_px, tr.loop_sanity_factor * max(med_b, 1e-6))
        if sane:
            self._enqueue_polish("global", tr.global_ba_slices)
            self.loops_closed += 1
            self.session_loops_applied += 1
            self._last_loop_nkf = self._n_kf_host
            verified, applied = True, int(p["cand_sel"])
            profiling.count("sync.loop_sanity")
        else:
            self.map = p["m_pre"]
            dR_inv = p["dR"].T
            self._st = self._rebase_st(self._st, dR_inv, -(dR_inv @ p["dt"]))
            self._pending_loop = None
            self._loop_consistency = None
            verified, applied = "rejected", None
        self.loop_attempts.append((p["kf_slot"], p["cand_top"], p["score"],
                                   verified, applied))

    def _maybe_weld(self) -> None:
        """One weld phase per drained frame. Phase 1 reads each frozen
        map's best retrieval score for the newest keyframe: above
        loop_score_min, the best map's candidate is Sim(3)-verified
        against it, with one draw from the generator. Phase 2 reads the
        verdict: a verified weld (after judging a pending loop verdict,
        whose rollback map predates the import) imports the frozen map,
        drops it from the atlas and queues the global polish slices."""
        p = self._pending_weld
        if p is None:
            return
        tr = self.cfg.tracking
        self._pending_weld = None
        if "res" not in p:                      # phase 1: the scores
            scores = [float(sc) for _, sc in p["cands"]]
            profiling.count("sync.weld_probe", len(scores))
            best_i = int(np.argmax(scores))
            if scores[best_i] <= tr.loop_score_min:
                return
            fz = self.atlas[best_i]
            res = self._atlas_sim3(self.map, fz, p["kf_slot"],
                                   p["cands"][best_i][0],
                                   self._atlas_noise(fz))
            self._pending_weld = dict(best_i=best_i, res=res)
            return

        best_i, res = p["best_i"], p["res"]     # phase 2: the verdict
        profiling.count("sync.weld_verdict")
        if not bool(res.ok) or best_i >= len(self.atlas):
            return
        self._resolve_loop_sanity()
        self.map, _n_kf_imp, _n_lm_imp = self._atlas_weld(
            self.map, self.atlas[best_i], res.sim3.s, res.sim3.R,
            res.sim3.t)
        self.atlas.pop(best_i)
        self._slots_used = int(self.map.n_kf)
        profiling.count("sync.weld_slots")
        self._n_kf_host = max(self._n_kf_host, self._slots_used)
        self._enqueue_polish("global", tr.global_ba_slices)
        self.welds_done += 1
        self._pending_loop = None               # slot ids predate the import
        self._st = self._st.replace(ba_window=self._covis_window(self.map))

    def _maybe_compact(self, n_kf_lagged: int) -> None:
        """Capacity management. The frame step stops inserting at
        MK - 1; when the lagged count reaches MK - 2 the table is
        compacted, and if that frees too little the most redundant
        keyframe is culled and the table compacted again. A cooldown
        keeps a full table that nothing can free from compacting every
        frame."""
        MK = self.cfg.map.max_keyframes
        if self._compact_cooldown > 0:
            self._compact_cooldown -= 1
            return
        if n_kf_lagged < MK - 2:
            return
        # A pending loop verdict's rollback map predates the compaction.
        self._resolve_loop_sanity()
        self._compact_cooldown = self.cfg.tracking.kf_min_interval + 1
        self.map, n_valid = self._compact_step(self.map)
        self._slots_used = int(n_valid)
        profiling.count("sync.compact")
        # Slot ids moved: the pending probes and the window are stale.
        self._pending_loop = None
        self._pending_weld = None
        self._loop_consistency = None
        self._st = self._st.replace(ba_window=self._covis_window(self.map))
        if self._slots_used >= MK - 2:
            self.map, _n = self._forced_cull_step(self.map)
            self.map, n_valid = self._compact_step(self.map)
            self._slots_used = int(n_valid)
            profiling.count("sync.compact")
            self._st = self._st.replace(
                ba_window=self._covis_window(self.map))

    def _enqueue_polish(self, kind: str, n_slices: int) -> None:
        """Queue ``n_slices`` one-iteration slices with a halving
        damping (floored at 1%); pruning on the last slice only."""
        base = self.cfg.tracking.ba_slice_damping
        self._polish_queue = [
            (kind, max(base * (0.5 ** i), base * 1e-2), i == n_slices - 1)
            for i in range(n_slices)]

    def _on_keyframe_inserted(self, kf_slot: int, n_kf: int, ts: float,
                              pos, quat) -> None:
        """Keyframe-rate host reactions to an insert, learned from the
        lagged summary: maintenance, the young and wide polish
        scheduling and the loop-closing probe. (The JAX System also
        gates these on its warm-up readiness, which is always set
        here.)"""
        tr = self.cfg.tracking
        self._n_kf_host += 1
        self._slots_used = n_kf
        self._reloc_boundary_next_kf = False
        self._kf_trajectory.append((ts, np.asarray(pos), np.asarray(quat)))
        with profiling.span("slam.mapping"):
            self.map = self._maintain_step(self.map)
        # Young one-anchor re-solve, once per map, after a collapse
        # reset, deferred while a probe is pending. (No map-age bound, as
        # in the reference.)
        if tr.young_ba_at_kf > 0 and not self._young_polish_done \
                and self._had_collapse_reset \
                and n_kf >= tr.young_ba_at_kf \
                and not self._collapse_active \
                and not self._polish_queue:
            self._young_polish_done = True
            self._enqueue_polish("young", tr.young_ba_slices)
        if tr.wide_ba_every_kf > 0 \
                and self._n_kf_host % tr.wide_ba_every_kf == 0 \
                and not self._polish_queue:
            self._enqueue_polish("wide", tr.wide_ba_slices)
        # Loop probe: retrieval now, its score read on the next drained
        # frame; none while a tracked frame is weak or within
        # loop_cooldown_kf keyframes of an applied closure.
        if (kf_slot >= tr.loop_min_gap_kf and self._pending_loop is None
                and self._last_inliers >= tr.loop_min_track_inliers
                and self._n_kf_host - self._last_loop_nkf
                >= tr.loop_cooldown_kf):
            with profiling.span("slam.loop"):
                cands, scores = self._loop_candidate(self.map, kf_slot)
            self._pending_loop = dict(kf_slot=kf_slot, cands=cands,
                                      scores=scores)
        # Atlas weld probe: the new keyframe's signature against every
        # frozen map's keyframe table, read on the next drained frame.
        if self.atlas and self._pending_weld is None:
            sig = self.map.kf_signature[kf_slot]
            self._pending_weld = dict(
                kf_slot=kf_slot,
                cands=[self._atlas_cand(fz, sig) for fz in self.atlas])

    # ------------------------------------------------------------------
    # Outputs

    def _twc(self):
        Rwc, twc = se3_inverse(self._st.R, self._st.t)
        profiling.count("sync.twc", 2)
        return twc.cpu().numpy(), quat_from_rotmat(Rwc).cpu().numpy()

    def keyframe_poses(self):
        """(timestamps, positions, quaternions) of the surviving
        keyframes, read from the current map."""
        n = min(int(self.map.n_kf), self.map.max_keyframes)
        sel = torch.nonzero(self.map.kf_valid[:n]).reshape(-1)
        if sel.numel() == 0:
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))
        Rws, tws = se3_inverse(self.map.kf_R[sel], self.map.kf_t[sel])
        t0 = self._t0 or 0.0
        return (t0 + self.map.kf_timestamp[sel].cpu().numpy()
                .astype(np.float64),
                tws.cpu().numpy(), quat_from_rotmat(Rws).cpu().numpy())

    def keyframe_trajectory_tum(self) -> str:
        """TUM-format keyframe trajectory (timestamp tx ty tz qx qy qz qw)."""
        ts, pos, quat = self.keyframe_poses()
        lines = [f"{ts[i]:.6f} {pos[i][0]:.7f} {pos[i][1]:.7f} "
                 f"{pos[i][2]:.7f} {quat[i][0]:.7f} {quat[i][1]:.7f} "
                 f"{quat[i][2]:.7f} {quat[i][3]:.7f}" for i in range(len(ts))]
        return "\n".join(lines) + "\n"

    def trajectory(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        return list(self._trajectory)

    def shutdown(self) -> List[TrackOutput]:
        """Final drain: the in-flight frames and the poses held by a
        pending collapse probe. Idempotent."""
        return self._flush_pipeline(final=True)

    def save_map(self, path: Optional[str] = None) -> str:
        """Checkpoint the map (``io/map_io.py``); returns the path."""
        return map_io.save_map(self.map, path)

    def load_map(self, path: Optional[str] = None) -> None:
        """Resume from a checkpoint on this System's device: the System
        is LOST, so tracking restarts by relocalizing against the loaded
        map. The file's capacities are taken as they are, as in the
        reference."""
        self.map = map_io.load_map(path, device=self.device)
        self._n_kf_host = int(self.map.n_kf)
        self._slots_used = self._n_kf_host
        self.state = TRACKING_LOST
        self._init_frames.clear()
        self._lost_frames = 0
        self._st = self._st.replace(ba_window=self._covis_window(self.map))
