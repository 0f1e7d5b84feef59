"""The System facade: host orchestration of the monocular tracking path.

Counterpart of ``send_slam_tpu/models/system.py`` for the port's first
slice: ``track_monocular`` with the multi-reference two-view init
(``_try_initialize`` / ``_init_multi`` / ``_commit_init``), the map
bootstrap, the per-frame step (motion-model prediction, tracking, the
keyframe decision, keyframe insertion with triangulation, the insert
BA burst and the amortized one-iteration BA slices), the one-frame-late
summary handling with the same lag, the same young-map reset at
``n_kf <= 5`` and the same LOST transition, and the per-keyframe map
maintenance.

What the JAX package's jitted programs decide with ``lax.cond`` is a
Python branch here. Randomness (RANSAC minimal sets) comes from a
``torch.Generator`` reset with the session, as the JAX System resets
its PRNG key.

Not in this slice, and refused at construction: the young-map collapse
probe and retry (``init_collapse_frac`` must be 0), the init backfill
(``init_backfill`` False), the young/wide/global polish slices
(``young_ba_at_kf`` and ``wide_ba_every_kf`` 0) and loop closing
(``loop_min_gap_kf`` must be at least ``max_keyframes``, so no probe can
fire). Relocalization, the atlas, keyframe compaction and map I/O are
not ported either: a LOST session stays LOST, and reaching the keyframe
capacity raises NotImplementedError.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from send_slam_tpu_torch.config import EngineConfig
from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.geometry.se3 import (
    quat_from_rotmat, se3_compose, se3_exp, se3_inverse, se3_log,
)
from send_slam_tpu_torch.models.covisibility import (
    covis_window_ids, cull_redundant_keyframes,
)
from send_slam_tpu_torch.models.frame import Frame, make_frame
from send_slam_tpu_torch.models.initializer import InitResult, two_view_init
from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
from send_slam_tpu_torch.models.local_mapping import (
    insert_keyframe_with_triangulation,
)
from send_slam_tpu_torch.models.map_state import (
    MapState, add_landmarks, empty_map, insert_keyframe,
    prune_zero_obs_landmarks, update_landmark_stats,
)
from send_slam_tpu_torch.models.tracking import track_frame
from send_slam_tpu_torch.ops.hamming import Matches

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


class TrackOutput(NamedTuple):
    """Host-side result of one frame (the pose packet's contents)."""

    tracking_state: int
    position: Optional[np.ndarray]      # Twc translation (3,)
    orientation: Optional[np.ndarray]   # Twc unit quaternion (x,y,z,w)
    n_inliers: int
    timestamp: float
    n_landmarks: int = -1


def _check_slice_config(cfg: EngineConfig) -> None:
    tr, mp = cfg.tracking, cfg.map
    refused = []
    if tr.init_collapse_frac > 0:
        refused.append("init_collapse_frac > 0 (collapse probe)")
    if tr.init_backfill:
        refused.append("init_backfill (trajectory backfill)")
    if tr.young_ba_at_kf > 0:
        refused.append("young_ba_at_kf > 0 (young-map polish)")
    if tr.wide_ba_every_kf > 0:
        refused.append("wide_ba_every_kf > 0 (wide polish)")
    if tr.loop_min_gap_kf < mp.max_keyframes:
        refused.append("loop_min_gap_kf < max_keyframes (loop closing)")
    if mp.ba_window > 64:
        refused.append("ba_window > 64 (chunked BA)")
    if abs(cfg.orb.scale_factor - 1.2) > 1e-9:
        refused.append("scale_factor != 1.2")
    if refused:
        raise NotImplementedError(
            "send_slam_tpu_torch does not port these features yet; turn "
            "them off: " + "; ".join(refused))


def slice_config(cfg: EngineConfig) -> EngineConfig:
    """``cfg`` with every feature this slice leaves out turned off."""
    tr = dataclasses.replace(
        cfg.tracking, init_collapse_frac=0.0, init_backfill=False,
        young_ba_at_kf=0, wide_ba_every_kf=0,
        loop_min_gap_kf=max(cfg.tracking.loop_min_gap_kf,
                            cfg.map.max_keyframes))
    return cfg.replace(tracking=tr)


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
        _check_slice_config(config)
        self.cfg = config
        self.device = resolve_device(device)
        cam = config.camera
        self._K = torch.tensor(
            [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._n_init_refs = len(config.tracking.init_ref_gaps)
        # Frames through make_frame (each runs one FAST launch on the
        # card, over every pyramid level).
        self.frames_extracted = 0
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

    # ------------------------------------------------------------------
    # Device steps

    def _make_frame(self, img, ts) -> Frame:
        self.frames_extracted += 1
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
        """KF0 (identity) + KF1 (R, t) + the initial landmarks, then the
        post-init BA with KF0 fixed."""
        orb = self.cfg.orb
        N = fa.feat.capacity
        dev = self.device
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
        return local_bundle_adjustment(m, self._K, self.cfg.map, iters=10,
                                       n_fixed=1)

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
        res = track_frame(
            R_pred, t_pred, m.lm_pos, m.lm_desc, m.lm_valid,
            frame.uv_und, frame.feat.desc, frame.feat.valid,
            frame.feat.octave, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.width, cam.height, tr, scale_factor=orb.scale_factor,
            search_radius=tr.search_radius_px, R_rescue=st.R, t_rescue=st.t,
            lm_normal=m.lm_normal, lm_dist_min=m.lm_dist_min,
            lm_dist_max=m.lm_dist_max, n_levels=orb.n_levels)
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
        insert = bool(need_kf)

        win = st.ba_window
        if insert:
            m, _kf_id, _n_new = insert_keyframe_with_triangulation(
                m, res.R, res.t, frame, res.matches.idx,
                res.matches.valid & res.inlier, self._K, tr,
                chain_break=chain_break, scale_factor=orb.scale_factor,
                n_levels=orb.n_levels, triangulate_backs=tr.triangulate_backs)
            win = covis_window_ids(m, W)[0]

        # --- amortized BA (the LocalMapping time slice) ---------------
        K_INS = tr.kf_insert_ba_iters
        ba_it = torch.where(need_kf, torch.full_like(st.ba_it, K_INS),
                            st.ba_it)
        run_ba = (~need_kf) & (m.n_kf >= 3) & (ba_it < tr.ba_slice_max)
        lam = torch.clamp(
            tr.ba_slice_damping * (0.5 ** ba_it.to(torch.float32)),
            min=tr.ba_slice_damping * 1e-2)
        if insert and int(m.n_kf) >= 3:
            m = local_bundle_adjustment(
                m, self._K, cfg.map, iters=K_INS,
                damping=tr.ba_slice_damping, window_ids=win, prune=True)
        elif bool(run_ba):
            m = local_bundle_adjustment(
                m, self._K, cfg.map, iters=1, damping=lam, window_ids=win,
                prune=ba_it >= tr.ba_prune_after)
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

    def _maintain_step(self, m: MapState) -> MapState:
        """Keyframe-rate maintenance: zero-obs landmark pruning and
        redundant keyframe culling."""
        m = prune_zero_obs_landmarks(m)
        m, _ = cull_redundant_keyframes(m, max_cull=2)
        return m

    # ------------------------------------------------------------------
    # State machine

    def track_monocular(self, gray, timestamp: float) -> TrackOutput:
        """gray: (H, W) uint8 or float image. Returns the pose as Twc
        (world-from-camera). Device timestamps are session-relative."""
        if self._t0 is None:
            self._t0 = float(timestamp)
        ts_dev = float(timestamp) - self._t0
        if self.state in (TRACKING_OK, TRACKING_RECENTLY_LOST):
            return self._track_pipelined(gray, timestamp, ts_dev)

        self._flush_pipeline()
        if self.state in (TRACKING_NO_IMAGES_YET, TRACKING_NOT_INITIALIZED):
            self._try_initialize(self._make_frame(gray, ts_dev), ts_dev)
        if self.state == TRACKING_OK:
            pos, quat = self._twc()
            self._trajectory.append((timestamp, pos, quat))
            out = TrackOutput(TRACKING_OK, pos, quat, self._last_inliers,
                              timestamp)
            self._last_out = out
            return out
        return TrackOutput(self.state, None, None, 0, timestamp)

    def _commit_init(self, ref_frame: Frame, cur_frame: Frame,
                     res: InitResult, timestamp: float,
                     n_good=None) -> None:
        self.map = self._bootstrap_map(self.map, ref_frame, cur_frame, res)
        self._st = self._fresh_loop_state().replace(
            R=res.R, t=res.t, R2=res.R, t2=res.t,
            inliers_at_kf=res.n_good.to(torch.int32))
        self.state = TRACKING_OK
        self._n_kf_host = 2
        self._last_inliers = int(n_good if n_good is not None
                                 else res.n_good)
        self._init_best = None
        self._init_prev_cands = None
        self._init_tdir_rejects = 0
        self._init_frames.clear()
        self.init_commit_ts = timestamp
        t0 = self._t0 or 0.0
        ts_ref = t0 + float(ref_frame.timestamp)
        self._kf_trajectory.append(
            (ts_ref, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])))
        Rwc, twc = se3_inverse(res.R, res.t)
        self._kf_trajectory.append(
            (t0 + float(cur_frame.timestamp), twc.cpu().numpy(),
             quat_from_rotmat(Rwc).cpu().numpy()))

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
                                       frame, 1.0)
        self.init_attempts += 1
        p = probes.cpu().numpy().reshape(self._n_init_refs, 7)

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
            self._commit_init(refs[certified[1]][1], frame,
                              _index_result(res, certified[1]), timestamp,
                              n_good=certified[3])
            return
        self._init_tdir_rejects += 1
        if self._init_tdir_rejects >= tr.init_tdir_max_rejects:
            best = self._init_best
            self._commit_init(best[2], best[3], best[1], best[4],
                              n_good=best[5])
            return
        self._init_prev_cands = (timestamp, self.init_attempts,
                                 [(c[2], c[4]) for c in cands])

    def _track_pipelined(self, gray, timestamp: float,
                         ts_dev: float) -> TrackOutput:
        """Run this frame's step; act on the summary ``pipeline_depth``
        frames late, as the JAX System does."""
        st_prev = self._st
        m2, st2, summary = self._frame_step(self.map, self._st, gray, ts_dev)
        self._pending.append(dict(ts=timestamp, st_prev=st_prev,
                                  summary=summary))
        self.map, self._st = m2, st2
        depth = self.cfg.tracking.pipeline_depth
        while len(self._pending) > depth:
            if self.state not in (TRACKING_OK, TRACKING_RECENTLY_LOST):
                break
            self._ready.append(self._process_lagged())
        if self._ready:
            return self._ready.pop(0)
        if self._last_out is not None:
            return self._last_out
        st = (TRACKING_NOT_INITIALIZED if self.state == TRACKING_OK
              else self.state)
        return TrackOutput(st, None, None, 0, timestamp)

    def _process_lagged(self) -> TrackOutput:
        ent = self._pending.pop(0)
        tr = self.cfg.tracking
        s = ent["summary"].cpu().numpy()
        n_inl = int(s[S_INLIERS])
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
        if s[S_KF] > 0.5:
            self._on_keyframe_inserted(ts, pos, quat)
        if n_kf >= self.cfg.map.max_keyframes - 2:
            raise NotImplementedError(
                "keyframe table full: compaction is not ported yet")
        self._trajectory.append((ts, pos, quat))
        out = TrackOutput(TRACKING_OK, pos, quat, n_inl, ts,
                          n_landmarks=int(s[S_NLM]))
        self._last_out = out
        return out

    def _on_keyframe_inserted(self, ts: float, pos, quat) -> None:
        self._n_kf_host += 1
        self._kf_trajectory.append((ts, np.asarray(pos), np.asarray(quat)))
        self.map = self._maintain_step(self.map)

    def _flush_pipeline(self) -> List[TrackOutput]:
        """Drain in-flight frames (state transitions, shutdown)."""
        outs = list(self._ready)
        self._ready.clear()
        while self._pending:
            if self.state not in (TRACKING_OK, TRACKING_RECENTLY_LOST):
                self._pending.clear()
                break
            outs.append(self._process_lagged())
        return outs

    # ------------------------------------------------------------------
    # Outputs

    def _twc(self):
        Rwc, twc = se3_inverse(self._st.R, self._st.t)
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
        """Final drain of the in-flight frames."""
        return self._flush_pipeline()

    def save_map(self, path=None):
        raise NotImplementedError("map I/O is not ported yet")

    def load_map(self, path=None):
        raise NotImplementedError("map I/O is not ported yet")
