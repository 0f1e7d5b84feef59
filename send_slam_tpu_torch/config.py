"""Typed configuration for the whole engine (the port's own copy).

A field-for-field copy of the dataclasses in the JAX package's
``send_slam_tpu/config.py``: the port must not import that package (its
``__init__`` imports JAX, which the CUDA machine does not have), so the
knob defaults live here too. ``tests/test_torch_config.py`` holds every
default equal to the JAX package's. The long design notes on each knob
stay in the JAX package's copy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB front-end parameters (reference …cc:193-206)."""

    n_features: int = 1250          # ORBextractor.nFeatures
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    n_levels: int = 8               # ORBextractor.nLevels
    ini_th_fast: int = 20           # ORBextractor.iniThFAST
    min_th_fast: int = 7            # ORBextractor.minThFAST
    # TPU-specific static capacities.
    # Max FAST candidates kept per pyramid level before grid NMS.
    max_candidates_per_level: int = 4096
    # Grid cells (per side) used for spatially-uniform keypoint selection.
    grid_cells: int = 8
    patch_size: int = 31            # orientation / descriptor patch
    half_patch: int = 15
    edge_threshold: int = 19        # border margin like ORB-SLAM3
    # Sub-pixel corner localization: 3-point parabola fit on the pre-NMS
    # FAST score map. ORB-SLAM3 keeps integer corners; the ~0.3 px
    # quantization noise is a dominant triangulation-depth error term on
    # quantized (uint8) imagery (bench scenario on CPU: ATE 0.32 ->
    # 0.027 with this on) AND the noise floor that makes keyframe-
    # placement basins fragile (the 40-frame VO scenario swings 4x on a
    # one-frame KF shift without it, and is flat with it). Default ON
    # since round 4: the branch-loop regression that blocked the flip
    # was the loop-closure spree, fixed by the cooldown/degenerate-
    # score/sanity guards (see TrackingConfig loop_* fields).
    subpixel: bool = True

    @property
    def per_level_features(self) -> Tuple[int, ...]:
        """Static per-level keypoint budget, geometric in 1/scale like
        ORB-SLAM3's ORBextractor ctor, summing exactly to n_features."""
        inv = 1.0 / self.scale_factor
        n_desired = []
        factor = 1.0
        denom = (1.0 - inv ** self.n_levels) / (1.0 - inv)
        for _ in range(self.n_levels):
            n_desired.append(self.n_features * factor / denom)
            factor *= inv
        counts = [max(1, int(round(x))) for x in n_desired]
        # Fix rounding drift so the total is exactly n_features.
        counts[0] += self.n_features - sum(counts)
        return tuple(counts)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + radtan intrinsics (reference settings YAML Camera1.*)."""

    # "PinHole" (radtan k1 k2 p1 p2 k3) or "KannalaBrandt8" (fisheye,
    # k1..k4 stored in the k1, k2, p1, p2 slots) — the two camera
    # models ORB-SLAM3 supports (CameraModels/, CMakeLists.txt:68-69).
    model: str = "PinHole"
    width: int = 640
    height: int = 480
    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    camera_id: int = 0


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed capacities for the on-device map (static shapes)."""

    max_keyframes: int = 256        # keyframe ring capacity
    max_landmarks: int = 16384      # landmark table capacity
    # Max landmarks considered in one tracking step (local map window).
    track_window: int = 2048
    # Local BA window: number of keyframes optimized jointly.
    ba_window: int = 8
    ba_fixed: int = 2               # additional fixed anchor keyframes
    # Max observations per landmark kept in the observation table.
    max_obs_per_landmark: int = 16


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    # RANSAC / matcher
    hamming_th_high: int = 100      # ORB-SLAM3 TH_HIGH
    hamming_th_low: int = 50        # ORB-SLAM3 TH_LOW
    ratio_test: float = 0.9
    search_radius_px: float = 15.0
    # Octave window of search-by-projection: match keypoints within
    # +-octave_slack pyramid levels of PredictScale's level. ORB-SLAM
    # uses +-1 on real imagery; our synthetic-dot octave assignment is
    # noisy (8-14% of true keyframe associations measured at |dlvl|>=2)
    # and a gated-out true match mis-binds to a similar dot (no ratio
    # test on projection windows). Round-4 A/B, 8 m march into new
    # territory: KF-traj RMS 0.465 m at slack 1 -> 0.039 m at slack 2,
    # cross-map weld restored.
    octave_slack: int = 2
    # Motion model: fraction of the frame-to-frame motion extrapolated
    # into the next prediction. 1.0 = classic constant-velocity; the
    # undamped model is a positive-feedback loop (prediction noise ->
    # biased window matches -> amplified pose noise) that diverges on
    # small-motion sequences. 0.5 keeps half the prior, bounded noise.
    velocity_damping: float = 0.5
    # Tracking pipeline depth: how many frames may be in flight before
    # the host fetches a frame's summary and acts on it. Covers the
    # device->host round-trip latency (depth ~= latency / frame
    # period): 2 suffices co-located; a remote/tunneled device wants
    # 6+. Decisions (keyframes, lost) lag by this many frames.
    pipeline_depth: int = 2
    # DEPRECATED no-op (kept so existing configs still construct).
    # Round 2's elastic drain stretched the pipeline to
    # stretch * depth while a fetch was in transit; that made the
    # host dispatch schedule — and therefore the map — depend on
    # network timing (bimodal bench ATE across identical runs). The
    # drain is now always deterministic: pop (blocking) at exactly
    # ``pipeline_depth`` in-flight frames.
    pipeline_stretch: int = 4
    # Pose-only Gauss-Newton: inner linearizations per round (rounds:
    # 2 wide-window + 4 tight-window, with chi2 outlier
    # reclassification between rounds — g2o PoseOptimization's
    # structure). NOTE a trimmed 3-step schedule was tried and reverted:
    # track_frame cost is dominated by the two matching passes (the GN
    # chain is latency-noise on TPU), while marginal-tracking scenarios
    # (long-session capacity churn, branch loops) measurably degraded.
    pose_gn_inner: int = 5
    huber_delta: float = 2.447      # sqrt(5.991) px, chi2 95% 2-dof
    min_track_matches: int = 15
    # Keyframe policy
    kf_min_interval: int = 3        # frames
    kf_tracked_ratio: float = 0.9   # new KF if tracked < ratio * ref
    # Weak-trigger hysteresis: the under-ratio condition must hold for
    # this many CONSECUTIVE frames before it places a keyframe (1 =
    # ORB-SLAM3-like immediate trigger). A single noisy inlier dip
    # placing a KF re-anchors the ratio reference low and cascades the
    # whole KF schedule — the round-3 TPU/CPU basin-divergence
    # mechanism. kf_max_interval staleness is unaffected. Default 2:
    # measured on the confuser scenario (scripts/confuser_probe.py),
    # the undamped trigger left the build one ULP-perturbation away
    # from losing its loop closure; with 2 the closure lands on the
    # right region (ATE 0.016) and the spree guards engage cleanly.
    kf_weak_frames: int = 2
    kf_max_interval: int = 10       # force a KF after this many frames
    # Weakness REFERENCE for the under-ratio trigger. False (classic):
    # the inlier count frozen at the last insertion instant — but that
    # anchor RATCHETS: one noise-dip-placed keyframe re-anchors it low
    # and the weak trigger goes deaf for the rest of the run (the
    # schedule degrades to stale-only; the round-3 TPU bench run
    # placed 10 KFs in 74 frames this way and drifted into a tracking
    # loss). True: reference = the newest keyframe's CURRENT count of
    # mature map points (lm_vote_count >= min(3, n_kf) observations,
    # ORB-SLAM3's Tracking::NeedNewKeyFrame nRefMatches =
    # TrackedMapPoints(minObs) on the reference KF) — a map property
    # that noise dips cannot re-anchor. Round-4 A/B on the exact-
    # numerics build: CPU bench scenario 0.022/0.0019 ON vs
    # 0.041/0.0027 OFF, TPU 0.0243 vs 0.0272 — but the textured-room
    # e2e regressed 0.23 -> 0.304 (bar 0.30) with ON. All deltas are
    # basin-level; the suite bar is the regression detector, so the
    # default stays OFF until ON wins beyond basin noise.
    kf_ref_map: bool = False
    # Which earlier keyframes (slots back from the new one) new-point
    # triangulation pairs against. On forward-marching scenes the most
    # recent keyframes have the smallest baselines; spreading the refs
    # widens parallax at the same cost.
    triangulate_backs: Tuple[int, ...] = (1, 2, 3)
    # Amortized bundle adjustment (the TPU-native analog of the
    # LocalMapping thread overlapping Tracking): instead of a
    # multi-iteration local-BA burst at keyframe rate stalling the
    # frame chain, ONE Gauss-Newton slice runs in-graph per frame over
    # the newest keyframe's covisibility window, with the Levenberg
    # damping decayed across slices (constant damping under-converges
    # — see local_ba.py). Slices stop after ba_slice_max per keyframe;
    # observation pruning arms once the window has had ba_prune_after
    # slices (pruning an under-converged window eats true matches).
    ba_slice_max: int = 6
    ba_slice_damping: float = 1e-3
    ba_prune_after: int = 3
    # GN iterations run INSIDE the insert branch before the next frame
    # can track: freshly triangulated landmarks must never be exposed
    # raw (forward-marching scenes triangulate at low parallax; one
    # frame tracked against unrefined structure diverges the chain).
    kf_insert_ba_iters: int = 4
    # Wide/global polish runs as a queue of single-iteration slices
    # (one dispatched per frame) instead of one >100 ms dispatch.
    wide_ba_every_kf: int = 8       # enqueue wide slices every Nth KF
    wide_ba_slices: int = 5
    # A wide/global polish slice whose newest-KF correction exceeds
    # EITHER bound rebases the speculative pose chain (translation is
    # measured relative to the last inter-keyframe baseline, so the
    # test is scale-free). Below both bounds the next frame's pose GN
    # absorbs the delta; above them the chain would predict outside
    # the matcher window and tracking collapses in one frame.
    polish_rebase_min_deg: float = 0.25
    polish_rebase_baseline_frac: float = 0.3
    # Wide-BA window selection: hybrid (recent half + most-covisible
    # old half, covisibility.wide_window_ids) vs pure recency. Hybrid
    # couples revisited old structure (out-and-back drift polish);
    # on forward-marching scenes the old "anchors" may share only a
    # handful of drifted landmarks with the recent chain — a weakly
    # constrained coupling that can warp keyframe poses.
    wide_ba_covis_window: bool = True
    global_ba_slices: int = 8       # after a loop closure / map weld
    # Young-map re-solve (round 5): once the session holds
    # young_ba_at_kf keyframes, run young_ba_slices ONE-anchor recency
    # BA slices (one-shot per map). Everywhere else BA fixes >= 2
    # keyframes — correct for the marching window (monocular scale
    # must stay pinned) but it FREEZES the committed two-view init's
    # relative pose; a slightly-bent certified init (t-dir a few
    # degrees off at ~1 deg parallax) then warps the whole session
    # (round-5 TPU/CPU tail seeds: KF-warp with stream/kf scale
    # parity). The one-anchor burst lets the accumulated multi-view
    # observations re-solve KF1..n + structure; its transient scale
    # freedom is harmless one-shot (the gauge re-pins at the next
    # 2-anchor BA, and evaluation aligns in Sim3 anyway). 0 disables.
    young_ba_at_kf: int = 4
    young_ba_slices: int = 5
    # Two-view initializer
    init_ransac_iters: int = 512
    init_min_matches: int = 60
    # Multi-reference batched initialization (round 5): every init
    # frame scores the current frame against len(init_ref_gaps)
    # references drawn from a rolling frame cache at these gaps (in
    # frames behind the current one, clamped to what the cache holds),
    # all in ONE vmapped dispatch + ONE host fetch. Replaces the
    # round-2..4 single-ref scheme (fixed ref + probation + ref-slide
    # + dead-ref detection), whose certification latency was the
    # round-4 coverage collapse: the official bench spent 30-54 of 90
    # frames refusing to certify (two seeds never did — BENCH_r04
    # tracked_min 0) because one pair per frame gives the t-dir
    # consistency gate one reproducibility sample per frame. K gaps
    # per frame give C(K,2) same-frame cross-reference samples plus
    # the cross-frame one, so a healthy scene certifies in the first
    # frame where two gaps both verify. The gap ladder covers the
    # measured match-support-vs-parallax sweet spot (n_good 159 at
    # gap 7, 21 at gap 21 on the bench arc).
    init_ref_gaps: tuple = (2, 4, 8, 12)
    # Trajectory backfill at init commit (round 5): the frames between
    # the committed pair are still in the init cache with descriptors
    # extracted — ONE vmapped tracking dispatch recovers their poses
    # against the fresh map and emits them late through
    # TrackOutput.backfill (the pipeline already emits every pose one
    # frame late; these arrive one COMMIT late). They are real
    # measured poses, ride the collapse-probe hold like the commit
    # frame's own pose, and close part of the coverage gap a cautious
    # certification gate opens (the reference emits nothing for those
    # frames either — it just certifies less and pays the round-4
    # accuracy tail instead).
    init_backfill: bool = True
    # Legacy probation knob (no effect since round 5 — kept so stored
    # configs and __graft_entry__ kwargs keep loading): multi-ref
    # scoring commits the best certified pair immediately.
    init_probation_frames: int = 4
    init_strong_frac: float = 1.8
    # Also require n_good >= frac * (valid keypoints in the reference
    # frame): the absolute bar alone under-demands at high feature
    # counts (see initializer.py acceptance note).
    init_min_good_frac: float = 0.08
    init_min_parallax_deg: float = 0.8
    # Where the score's parallax discount SATURATES, as a multiple of
    # init_min_parallax_deg. KEEP AT 1.25: the round-4 A/B of 3.0
    # (prefer 2x-wider pairs during probation) REGRESSED the 10-seed
    # CPU sweep across the board (seed 17: 0.008 -> 0.344, 23: 0.037 ->
    # 0.128, 29: 0.085 -> 0.186) — support dominates E-matrix accuracy
    # and rewarding extra baseline picks pairs whose matching already
    # degraded (same conclusion as the round-3 94-vs-72-point A/B).
    # The low-parallax collapse tail is handled downstream by the
    # young-map scale-collapse detector (init_collapse_* below), not
    # by biasing pair selection.
    init_par_saturation: float = 1.25
    # Symmetric-transfer-error discount floor for the init score
    # (1.0 = discount disabled). Untested in isolation; enable only
    # with a fresh 10-seed sweep on both backends.
    init_err_floor: float = 1.0
    # Young-map scale-collapse detector (the round-4 sweep's tail
    # mechanism, seeds 71/104: a rotation-ambiguous init reconstructs
    # a baseline/depth ratio 5-15x small; tracking then "succeeds" on
    # the rotten structure with healthy inlier counts while the
    # estimated trajectory runs 13-80x slower than the init baseline
    # implied — stream alignment scale 91/556 vs healthy ~7). ONE
    # check, on the FIRST window_s of streamed motion after commit:
    # ratio(streamed velocity / init-pair baseline velocity) under
    # init_collapse_frac -> discard the young map and re-initialize
    # (ORB-SLAM-style young-map reset, extended to the case where
    # tracking does NOT fail). Single-shot because later windows are
    # unreliable (healthy runs drift to ~0.33 and one healthy init_v
    # was 6x overestimated). First-window ratio tracks run quality
    # monotonically in every measured run: >= 0.8 -> clean (ATE
    # 0.014-0.054), <= 0.31 -> mediocre-to-bad (0.17-0.38), < 0.07 ->
    # catastrophic. The costs are asymmetric — a false reset re-rolls
    # the init for ~10-15 frames, a false accept costs 0.2-0.4 ATE for
    # the whole session. Round 5 measured a ROTTEN init passing at
    # ratio 0.474 (TPU seed 11 -> session ATE 0.34; raising the bar to
    # 0.6 took it to 0.022), so the bad band extends to ~0.47 and the
    # threshold sits at 0.6 — margin on both sides of the measured
    # bad<=0.47 / healthy>=0.8 gap. A camera that brakes >1.7x within
    # the first window after init pays one spurious re-init (cheap
    # since the fail-fast cache retry); set frac=0 to disable.
    # While the probe is pending the engine HOLDS pose emission (the
    # caller sees "initializing"; ~window_s x fps frames once per
    # session, flushed into the trajectory on pass): emitting poses
    # that a failed probe would retract leaves the consumer a segment
    # in a dead map's gauge, which measured WORSE on stream ATE than
    # not resetting at all.
    init_collapse_frac: float = 0.6
    # Multiplier on the median-parallax acceptance floor, applied ONCE
    # from the THIRD collapse reset onward (see _init_par_scale).
    # DEFAULT 1.0 (boost disabled): every escalation point tried has
    # measurably starved re-certification rather than improved the
    # draw — from reset 1 (round-4 seed-93 A/B: tracked 45->60/90
    # without it) AND from reset 3 (round-5 TPU seed 104: commits
    # every ~0.35 s before the boost, then 1.73 s / 40+ attempts of
    # failed certification after it, ending the 90-frame run mid-probe
    # at 0/90). Mechanism both times: descriptor matching decays with
    # the gap faster than parallax grows (n_good 159 at gap 7 / 1 deg
    # vs 21 at gap 14 / 2 deg), so a raised floor prices out every
    # matchable pair in the cache. The knob stays for worlds with
    # denser texture where wider gaps still match.
    init_collapse_par_boost: float = 1.0
    init_collapse_window_s: float = 0.2
    # Probe window for RETRY probes (resets >= 1): catastrophic ratios
    # (0.005-0.17 measured) are detectable in ~3 frames; shortening
    # the re-probe cuts a failed cycle from ~13 to ~10 frames. The
    # FIRST probe keeps the full window — the grey zone (0.47 vs 0.8)
    # needs the span to average out per-frame jitter.
    init_collapse_retry_window_s: float = 0.1
    init_collapse_horizon_s: float = 1.5
    # Reset budget before the probe disarms. Was 3 through round 5
    # part 1 — and the disarm is a structural hole: the seeds that
    # burn the whole budget are exactly the pathological ones, and
    # their NEXT init committed unprobed (TPU seed 29: three resets,
    # then an unprobed rotten commit -> session ATE 0.184). 5 with the
    # cheap retry keeps worst-case hold time under ~55 frames.
    init_collapse_max_resets: int = 5
    # Translation-direction consistency gate on init commits (round-4
    # TPU seed-11 forensics): at the bench's ~0.9 deg median init
    # parallax the E-matrix t-direction is a RANSAC lottery — four
    # commits on one seed drew t-dir errors of 1.5/45/63/33 deg with
    # IDENTICAL support/parallax/|t|/depth-spread observables (the
    # rotten draws even scored higher), so no single-pair statistic
    # discriminates. What does: reproducibility. Acceptable candidates
    # sharing the current frame (different cached references — the
    # round-5 multi-ref batch) or one frame apart share a true
    # t-direction (the inter-reference motion delta is small), so two
    # independent draws agreeing within init_tdir_max_deg certify the
    # direction is data-determined, not sampled; disagreeing draws
    # mean the pairs are ambiguous and the commit waits for parallax
    # to grow. Healthy draws land ~1-3 deg apart, rotten tens of
    # degrees. 0 disables. Cross-FRAME comparisons additionally
    # require the previous candidates to be fresh: within
    # init_tdir_window_s OR from the immediately-previous attempt
    # (the liveness path for sparse wall-clock cadences — see the
    # round-4 deadlock note in system.py).
    init_tdir_max_deg: float = 12.0
    init_tdir_window_s: float = 0.12
    # Scale-consistency band on the SAME agreement check: the two
    # agreeing pairs must also imply the same camera speed in their
    # median-depth gauges (max/min of |t|/dt within this factor). A
    # rotation-ambiguous pair reconstructs its baseline 5-15x small
    # (the round-4 collapse-tail mechanism: healthy pair-vs-commit
    # ratios measured >= 0.8, collapsed 0.02-0.27), so direction
    # agreement alone can certify a rotten commit that then burns the
    # collapse-probe + retry cycle (~25 frames, seed-93 forensics).
    # 0 disables.
    init_vel_band: float = 2.5
    # Liveness cap: after this many CONSECUTIVE frames whose
    # acceptable candidates were all vetoed by the consistency gate,
    # stop vetoing and commit the best acceptable candidate seen —
    # erratic attempt cadence (wall-clock frame drops, looping
    # replays) or a genuinely curved path can make certification
    # impossible while the candidates themselves are fine.
    init_tdir_max_rejects: int = 6
    # Floor (in octave-equivalents) on the GATED landmark distance-band
    # width in tracking's projection gate: with few pyramid levels the
    # stored band is a sliver (1.2^2 = 1.44x at n_levels=3) and a
    # marching camera exits it between keyframe-rate refreshes —
    # measured: the 8-lane merge scenario lost a lane at step 9 with
    # the raw band. n_levels >= 7 configs are unchanged; 0 restores
    # the raw band.
    lm_band_floor_octaves: int = 6
    # Loop-closure robustness on long sessions (flagship lap-session
    # forensics, round 4): (a) loop probes are not dispatched while
    # tracking is thin — a Sim3 verified from a starved keyframe's few
    # garbage matches exploded the map 47x in one apply; (b) the
    # verified Sim3's scale must sit inside [1/loop_max_scale,
    # loop_max_scale] — intra-session drift between revisits is far
    # smaller, and the reprojection sanity gate cannot catch a
    # near-uniform rescale.
    loop_min_track_inliers: int = 60
    loop_max_scale: float = 2.5
    # Triangulation baseline floor (LocalMapping's new-landmark gate):
    # maximum cosine of the ray parallax between the two triangulating
    # views (0.99995 ~= 0.573 deg minimum parallax). Expressed as the
    # cosine, not degrees: the gate sits in a chaotic cascade, and even
    # a 1e-8 threshold shift from a degrees->cos conversion measurably
    # flips scenario outcomes. Lower the value (larger minimum angle)
    # to trade landmark count for depth conditioning.
    tri_min_parallax_cos: float = 0.99995
    # Loop closing
    loop_min_gap_kf: int = 20       # candidate must be this many KFs old
    loop_score_min: float = 0.35    # retrieval cosine threshold
    loop_min_matches: int = 12      # verified 3D-3D matches required
    # Temporal consistency: the retrieval hit must land in the same map
    # region (+- radius slots) on this many consecutive keyframe probes
    # before Sim3 verification runs (KeyFrameDatabase consistency
    # groups; 1 disables).
    loop_consistency_kf: int = 2
    loop_consistency_radius: int = 3
    # Essential-graph covisibility edges measured across more than this
    # many keyframe slots of accumulated drift are dropped from loop
    # PGO (0 = unlimited). Long-range edges measured in DRIFTED
    # coordinates fight the very correction the loop supplies — see
    # covisibility.covis_edges and the round-3 A/B note in CLAUDE.md.
    loop_covis_max_gap: int = 0
    # Closure-spree guards (round-3 branch-scenario diagnosis: 12
    # closures fired vs 6 in the passing config, the late ones with
    # degenerate ~1.0 retrieval scores, and the accumulated PGO passes
    # warped the whole map):
    # (a) cooldown — after an APPLIED closure the map is mid-polish
    #     (global-BA slices still queued); re-probing it immediately
    #     retrieves against half-corrected signatures/poses. Require
    #     this many NEW keyframes before the next probe may fire.
    loop_cooldown_kf: int = 8
    # (b) saturated retrieval scores are degenerate: a genuine revisit
    #     views the same structure from a DIFFERENT vantage, so its
    #     signature cosine is high but not ~1.0; near-perfect scores
    #     come from near-duplicate keyframes (self-matches past the
    #     temporal gap after a bad correction folded the map onto
    #     itself) and must not arm the consistency counter.
    loop_score_max: float = 0.995
    # (c) post-correction sanity: reject (do not commit) a verified
    #     closure whose corrected map reprojects WORSE than
    #     max(loop_sanity_px, loop_sanity_factor * pre-correction
    #     median). A consistent closure leaves the median observation
    #     residual near where drift left it; a map-warping one (wrong
    #     candidate, contradictory PGO edges) explodes it.
    loop_sanity_px: float = 8.0
    loop_sanity_factor: float = 3.0
    # Relocalization acceptance: stricter than min_track_matches —
    # a marginal wide-window "success" from unmapped territory resets
    # the atlas patience counter forever and blocks the map freeze
    # (ORB-SLAM3's Relocalization demands >= 50 PnP inliers).
    reloc_min_matches: int = 40
    # Atlas multi-map (ORB-SLAM3: new map on prolonged tracking loss,
    # weld on place-recognition overlap).
    atlas_reloc_patience: int = 15  # failed reloc frames before freezing
    atlas_min_kf: int = 10          # map must be this mature to freeze
    max_atlas_maps: int = 4         # frozen maps kept (oldest dropped)


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """External contract ports. The reference confusingly bakes
    ORB_SLAM3_WS_PORT=4000 into the container (dockerfile:4) while the
    TCP frame listener is :5000 (application.ex:80); here each endpoint
    is one explicit value."""

    http_port: int = 4000           # panel + /client WS (web_server.ex)
    tcp_port: int = 5000            # MessagePack frame/pose compat port
    # Optional pose-only WS endpoint (PoseWebServer parity, :4001 in
    # the reference, disabled there and off by default here too).
    pose_port: int = 0              # 0 = disabled
    host: str = "127.0.0.1"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    orb: OrbConfig = OrbConfig()
    camera: CameraConfig = CameraConfig()
    map: MapConfig = MapConfig()
    tracking: TrackingConfig = TrackingConfig()
    server: ServerConfig = ServerConfig()
    dtype: str = "float32"          # geometry dtype
    image_dtype: str = "float32"    # pyramid dtype on device

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = EngineConfig()


def from_orbslam_yaml(path_or_text: str) -> EngineConfig:
    """Build an EngineConfig from an ORB-SLAM3 settings YAML — the
    format the reference adapter generates for the backend
    (orbslam3_mono_networked.cc:158-223: Camera1.fx/fy/cx/cy/k1...,
    Camera.width/height/fps, ORBextractor.nFeatures/scaleFactor/
    nLevels/iniThFAST/minThFAST). Accepts a path or the YAML text.
    The reference files start with the "%YAML:1.0" OpenCV header, which
    plain YAML parsers reject — it is stripped here."""
    import os
    import yaml

    text = path_or_text
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    lines = [l for l in text.splitlines()
             if not l.strip().startswith("%YAML") and l.strip() != "---"]
    data = yaml.safe_load("\n".join(lines)) or {}

    def get(key, default):
        return data.get(key, default)

    cam = CameraConfig(
        model=str(get("Camera.type", "PinHole")),
        width=int(get("Camera.width", 640)),
        height=int(get("Camera.height", 480)),
        fx=float(get("Camera1.fx", get("Camera.fx", 517.3))),
        fy=float(get("Camera1.fy", get("Camera.fy", 516.5))),
        cx=float(get("Camera1.cx", get("Camera.cx", 318.6))),
        cy=float(get("Camera1.cy", get("Camera.cy", 255.3))),
        k1=float(get("Camera1.k1", get("Camera.k1", 0.0))),
        k2=float(get("Camera1.k2", get("Camera.k2", 0.0))),
        p1=float(get("Camera1.p1", get("Camera.p1", 0.0))),
        p2=float(get("Camera1.p2", get("Camera.p2", 0.0))),
        k3=float(get("Camera1.k3", get("Camera.k3", 0.0))),
        fps=float(get("Camera.fps", 30.0)),
    )
    orb = OrbConfig(
        n_features=int(get("ORBextractor.nFeatures", 1250)),
        scale_factor=float(get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(get("ORBextractor.minThFAST", 7)),
    )
    return EngineConfig(camera=cam, orb=orb)


def tum_fr1_config() -> EngineConfig:
    """TUM fr1 intrinsics (freiburg1: 517.3 516.5 318.6 255.3,
    distortion 0.2624 -0.9531 -0.0054 0.0026 1.1633)."""
    cam = CameraConfig(
        width=640, height=480,
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        fps=30.0,
    )
    return EngineConfig(camera=cam)
