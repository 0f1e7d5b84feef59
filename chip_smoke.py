#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (send_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, printing no result).
Phases, each printing one JSON line:

1. environment: the card, its power limit (nvidia-smi), the nvcc build
   of the CUDA FAST kernel from send_slam_tpu_torch/csrc/ and its
   -Xptxas -v report (registers, shared memory, spills);
2. kernel_check: the FAST kernel held against its plain PyTorch version
   on the card under torch.equal (every level shape of a 640x480 frame,
   a ragged 100x128 and a 7x9 image, a batch of 3; thresholds 7 and 20;
   raw and NMS maps), then one launch over the whole 8-level pyramid,
   one over a batch of 8 such pyramids, each lanes path's own launch at
   its batch, levels and data (phases 15 and 17), one launch over
   the 8-level pyramid of a textured frame at scales 1.3 and 1.5 (odd
   level shapes: 369x492, 284x379, ... at 1.3), and one over a 752x480
   frame's 8 levels at 1.2 (EuRoC's width: 480x752, 400x625, ...,
   125x200);
3. kernel_times: per 640x480 frame, one launch over the 8 levels (device
   time queued behind a spin kernel, and the unqueued launch interval),
   8 one-level launches of the same kernel (both times), the plain
   version, batches of 8 and of 2 pyramids (the kernel and the plain
   version), scale_path's launch (8 levels at 1.3; the kernel and the
   plain version), dataset_euroc's (8 levels of 752x480), and the bytes
   and operations bounds (the operations counted on the timed inputs);
4. frontend_check: make_frame on the card against make_frame on the CPU
   (the plain path) on one 640x480 frame;
5. main_path: System.track_monocular at the flagship configuration
   (640x480, 1250 features, 8 levels, 256 keyframes, 16384 landmarks,
   BA window 8) with the JAX package's default options, loop closing on,
   over 90 frames of the synthetic bench scene (too few keyframes for a
   loop probe), with the kernel's launch count read around the run (one
   launch per make_frame, collapse retries included). Poses are counted
   as bench.py counts them: live OK outputs, every backfill triple and
   the shutdown drain;
5a. server_path: the drop-in backend, ``server.backend_client``'s
   ``BackendClient`` on the card, dials the reference's host played
   here on a loopback listener: the flagship camera's calibration
   packet (its default config is then the flagship one; it warms up),
   phase 5's 90 frames as the host sends them (P6, each gray value in
   three channels, 921,615 bytes), each sent once the backend has
   tracked the one before, then ``terminate``. Every pose packet must
   equal phase 5's (its backfill, then its live pose stamped with the
   frame's timestamp) bit for bit, in number and order; the PPM decode
   must return each image exactly through the native library; the TUM
   file must hold one line per keyframe of the final map; one FAST
   launch per make_frame, the warmup's included. Prints the warmup's
   seconds (this one and a second one on a fresh System; phase 1's
   build time beside them), ms from packet out to pose back, the host
   costs of the wire per frame and the bytes of a frame and a pose
   packet;
6. replay: phase 5a is a same-seed run on a fresh System in the same
   process: its whole trajectory (the shutdown drain included), the
   keyframe and landmark counts and the polish slices must be bit-equal
   to phase 5's; ms per call of the backfill, wide and young slices;
5b. app_path: ``server.app``'s ``Application`` on the card over the
   first 60 frames written as P6 files and replayed at 5 fps, ports 0:
   this script's own WebSocket client (raw socket, masked frames) reads
   ``/client`` until 12 live poses came, ``GET /metrics`` must count
   frames and two keyframes, ``GET /`` the panel page, and a raw TCP
   probe of the :tcp listener must decode a ``frame`` packet equal to
   the producer's frame; frames published, dropped by the bus and
   tracked, the /client latency from frame publish to pose JSON, one
   FAST launch per make_frame;
7. step_parity: at 3 tracked frames of the main path, the carried map and
   loop state go to a card System and a CPU System, and each runs
   _frame_step on the next image, one wide and one young polish slice,
   and _reloc_step on an earlier image with the same injected RANSAC
   draws; poses to 1e-4, inliers +-2, the keyframe decision, keyframe
   count, rebase flag and winning branch exactly, polished poses and
   landmarks to 1e-3; and the main path's first init commit
   (bootstrap_map: its BA of 10 iterations with one keyframe fixed) and
   its first keyframe insertion with the local BA that follows it, from
   their inputs kept during phase 5, card vs CPU: each field's error,
   the fields of BA_TOL at it and every other field within 1e-6 of its
   largest magnitude, integers exact;
8. relocalization: the main run's System is fed featureless frames
   until it is LOST, then frames of mapped territory; it must be
   TRACKING_OK again within 5 frames (its Sim(3)-aligned position
   error, the winning branch and the inliers are printed);
9. map_io: the main run's final map saved to a temporary npz and
   loaded into a fresh System on the card (every field equal under
   torch.equal, same dtype), which must relocalize within 3 mapped
   frames without initializing;
10. loop_path: the same configuration on the long bench's revisit scene
   (bench.py SLAM_BENCH_LONG: the seed-11 world on trajectory_laps with
   1000 frames over 6 laps), its first 260 frames, or 334 (two laps)
   when no closure has been applied by frame 260, with the launch count
   read around the run: every loop attempt with its frame, the frame of
   the first applied closure, the keyframe ATE just before it and at the
   end, the streamed ATE, tracked poses, ms per call of the loop
   programs, the device memory peak of each global slice. It fails
   unless a closure is applied, 8 global slices run and tracking is OK
   on 80% of the frames after the first apply;
11. loop_parity: the card's map at the first verified closure goes to a
   card System and a CPU System: _loop_sim3 with the same injected
   Gumbel draws (verdict, candidate and match count exact, inliers +-2,
   s/R/t 1e-4), _loop_apply with the run's LoopSim3 (keyframe poses and
   landmarks 1e-3, both reprojection medians 1e-3 relative) and the
   run's first _global_slice (1e-3); on the card, _loop_apply and
   _global_slice repeated from the same inputs must be bit-equal;
12. long_session: compaction on the card, tests/test_covisibility.py's
   140-frame arc at 640x480 with the flagship ORB and landmark table, a
   10-keyframe table, BA window 4 and that test's tracking overrides:
   more keyframes inserted than the table holds, at least one
   compaction, over 100 frames OK and 8 of the last 10, one FAST launch
   per make_frame; compactions, forced culls and the ms of each step;
13. atlas_path: tests/test_atlas.py's 210-frame occlusion scene at
   640x480 with the flagship ORB and map and that test's overrides: a
   map must freeze and weld back (the atlas empty at the end), 8 of the
   last 10 frames OK, one FAST launch per make_frame; the freeze and
   weld frames, imported keyframes and landmarks, the frozen map's
   device bytes and the ms of the weld probe, the cross-map Sim(3), the
   weld and the global slices;
14. long_parity: card against CPU on the maps of phases 12 and 13:
   _compact_step on a culled map and _forced_cull_step (every field
   equal), the cross-map candidate (id exact, score 1e-6 relative),
   _atlas_sim3 with one injected CPU Gumbel draw (verdict, match count
   and inlier mask exact, s/R/t 1e-5) and _atlas_weld under the run's
   Sim(3) (integers and booleans exact, floats 1e-6 of each field's
   largest magnitude); the forced cull of phase 13's final map (the
   flagship 256 / 16384 table; one keyframe culled) and the compaction
   of the card's culled map (every field equal); one global slice after
   the weld timed on the card alone; repeats of each on the card
   bit-equal;
15. lanes_path: two camera lanes of ``parallel.multicam_slam_step`` at
   the flagship configuration with loop closing on, lane 0 on the bench
   arc's path at twice its pace, lane 1 on it shifted 0.35 m along +x,
   one ring merge after step 70 and 10 steps more: both lanes commit
   and are TRACKING at the end, each on at least half of the steps
   after its commit; each lane's Sim(3)-aligned ATE; the merge ok on
   both lanes with at least 5 imports whose median distance to the true
   structure through the lane's gauge is at most 2 m; the merge's ms and
   peak device memory; the FAST launches read around the run, one per
   step, each over 2 lanes x 8 levels and each held against the plain
   version after the run; ms per step and per lane-step;
16. lanes_parity: the card's states before three of phase 15's steps go
   to the CPU: the first init commit, the first keyframe insertion past
   a bootstrap, and the first step both lanes track without a keyframe
   after both lanes' first keyframe. Each step runs on both (modes,
   counts, keyframe decisions and kf_total exact, inliers +-2, poses
   1e-4, maps as phase 14's; the fields that a commit's or keyframe's
   bundle adjustment writes at BA_TOL); both lanes' merges of the
   pre-merge maps on both with the same Gumbel noise (verdict, imports
   and import mask exact, s/R/t 1e-5); on the card the steps and the
   merges repeat bit for bit (the merges equal phase 15's);
17. lanes_ring: tests/test_parallel.py's merge scene, 8 lanes at
   160x120 over 14 steps and the ring merge: every lane TRACKING, at
   least 7 merges ok, one launch per step over 8 lanes x 3 levels, each
   held against the plain version, and a same-seed rerun bit-equal in
   its summaries, states and merged maps;
17a. lanes_mixed_mesh: the same 8 lanes on a mesh of the card and the
   CPU (four lanes on each, their slices moved to the CPU and back as a
   two-card mesh moves them): each of phase 17's steps from that run's
   state before it, held against its step at phase 16's bars (every
   field back on the card), and the merge of its final maps (verdicts
   and imports exact, floats 1e-5 relative);
17b. calibration: tests/test_calibration.py's 12 board views at 640x480
   (rendered without cv2) through detect_checkerboard and calibrate on
   the card and on the CPU (corners 1e-3 px, K 1e-4 relative; fx and fy
   within 2% of the truth), then GET /panel of an Application replaying
   the boards as .ppm files: 10 binary JPEG frames read with this
   script's WebSocket client and sent back as the calibrationFrames
   upload must be answered "OK", write the calibration JSON (its
   environment variable pointed at a temporary file) in the reference
   layout and publish CALIBRATION once; detect, calibrate, JPEG encode
   and decode ms, the panel's frames sent and skipped;
13a. scale_path: phase 5's 90 frames at OrbConfig(scale_factor=1.3),
   everything else flagship: one FAST launch per make_frame over the odd
   level shapes, at least 30 of 90 tracked as bench.py counts them, ATE;
18. dataset_tum: phase 5's 90 frames written as a TUM RGB-D tree (8-bit
   RGB PNGs by this script's own writer, their rows in all five filters;
   epoch stamps; ground truth at twice the frame rate, 3 ms late), read
   back with the port's open_sequence and PNG reader (each frame equal
   to the frame written, each stamp within 1e-6 s), tracked on the card
   at the flagship configuration as bench.py counts (at least 30 of 90),
   ATE at most 0.25 m against the ground truth parsed from disk, one
   FAST launch per make_frame; the PNG decode ms per frame;
19. dataset_euroc: the bench arc at EuRoC cam0's 752x480 and focal
   lengths as a mav0 tree (8-bit gray PNGs, ns stamps, the 17-column
   ground truth), the same checks, every FAST launch of the run held
   against the plain version afterwards;
20. textured_path: tests/test_stress_e2e.py's flagship lap, the textured
   room with every nuisance knob (noise, gain drift, blur, vignetting,
   an occluder, exposure steps, rolling shutter, foreground boxes), 120
   frames of one lap at MapConfig(64, 8192, ba_window=8): more than 90
   tracked, ATE under 0.15 m, fewer than 60 keyframes, one FAST launch
   per make_frame, ms per tracked frame;
21. dataset_example: ``examples/run_dataset_torch.py`` over 30 frames of
   the TUM tree in a subprocess started once the tree is written, as a
   user runs it, beside phases 18-20: exit code 0, its frames line, an
   ATE line, one TUM line per keyframe it reports (no accuracy bar: it
   imposes FR1's distorted intrinsics on undistorted frames); then
   offline_vs_main: phase 18's run against phase 5's (tracked, the
   frames only one emits, poses emitted twice; keyframes equal and
   positions of one frame within 1e-4 m) and textured_path's frame time
   beside the main path's.

The phases run in the order 1-5, 5a, 6, 5b, 7-21. Phases 12, 13 and 13a
run in a second process (``chip_smoke.py --sessions DIR``), phases 15
and 16 in a third (``chip_smoke.py --lanes DIR``), phases 17, 17a and
17b in a fourth (``chip_smoke.py --ring DIR``) and phases 18-21 in a
fifth (``chip_smoke.py --offline DIR``), all started after phase 5b and
running beside phases 7-11, so the times of phases 7-21 are taken beside
the other processes (run ``--sessions DIR``, ``--lanes DIR``, ``--ring
DIR`` or ``--offline DIR`` alone for their phases by themselves); their
lines are printed after phase 11's and phase 14's. Then the kernels
summary line and, last, {"ok": true, "device": ...}.
Any failed check exits non-zero; a watchdog ends the run after 360 s.
It imports nothing of JAX or of the JAX package, nor ``msgpack``,
``aiohttp`` or ``cv2``; the port's JPEG codec imports ``PIL`` when it is
called, and PNG is read by the port's own reader.
"""

from __future__ import annotations

import asyncio
import atexit
import base64
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

WATCHDOG_S = 360
N_FRAMES = 90
MIN_TRACKED = 30
PARITY_FRAMES = (30, 55, 80)    # replay frames whose carried state is held
RELOC_FRAMES = 5                # mapped frames allowed to relocalize
# The loop session: the long bench's scene and trajectory, cut to the
# first LOOP_FRAMES frames, or LOOP_FRAMES_MAX (two of its six laps) when
# no closure has been applied by then.
LOOP_TRAJ_FRAMES, LOOP_LAPS = 1000, 6
LOOP_FRAMES, LOOP_FRAMES_MAX = 260, 334
LOOP_MIN_OK_AFTER = 0.8         # tracked share of frames after the apply
MAP_IO_RELOC_FRAMES = 3         # mapped frames a loaded map may take
# The long session: tests/test_covisibility.py's arc and keyframe table.
LONG_FRAMES, LONG_MK, LONG_MIN_OK = 140, 10, 100
# The application session: the first APP_FRAMES main-path frames as P6
# files, replayed at APP_FPS (under the engine's ~80-190 ms per frame on
# the card), until APP_POSES live poses (not late backfill ones) came
# over /client.
APP_FRAMES, APP_FPS, APP_POSES = 60, 5.0, 12
# The camera lanes (phases 15-17): two flagship lanes on the bench arc's
# path at LANES_SPEED times its pace (at the bench's own pace the lanes
# commit on a short baseline and drift, and the card, the port on the
# CPU and the JAX package land in different basins), lane 1 shifted
# LANES_SHIFT m along +x (the lane spacing of tests/test_parallel.py),
# merged after LANES_MERGE_AFTER steps, then LANES_AFTER more; each
# lane's merge must import LANES_MIN_IMPORTS landmarks
# (tests/test_parallel.py's bar) whose median distance to the true
# structure, through the lane's gauge, is at most LANES_MAX_IMPORT_DIST
# m (the world's points lie 3-10 m deep). Then that test's 8 lanes at
# 160x120 over RING_STEPS steps and the ring merge.
LANES_SPEED, LANES_SHIFT, LANES_MERGE_AFTER, LANES_AFTER = 2.0, 0.35, 70, 10
LANES_MIN_IMPORTS, LANES_MAX_IMPORT_DIST = 5, 2.0
RING_LANES, RING_STEPS = 8, 14
# lanes_parity's bar, card vs CPU, for the map fields that a commit's or
# a keyframe's bundle adjustment writes: keyframe poses and landmark
# positions at step_parity's bar for the polish slices' BA (1e-3), the
# unit normals at the same, and the distance bounds, which are a
# landmark's distance times up to 1.2^7 (the pyramid's scale at its last
# level), at 1e-3 x 1.2^7.
BA_TOL = dict(kf_R=1e-3, kf_t=1e-3, lm_pos=1e-3, lm_normal=1e-3,
              lm_dist_min=1e-3 * 1.2 ** 7, lm_dist_max=1e-3 * 1.2 ** 7)
# The mixed mesh of lanes_ring (ROADMAP C.3): the same 8 lanes split over
# the card and the CPU, four on each, as a two-card mesh splits them.
MIXED_DEVICES = ("cuda", "cpu")
# Other pyramid scales: scale_path's (the main path's frames at 1.3) and
# kernel_check's odd level shapes (1.3 and 1.5).
SCALE_PATH_SCALE = 1.3
ODD_SCALES = (1.3, 1.5)
# The offline-evaluation phases (a fifth process): the main path's frames
# as a TUM tree (8-bit RGB PNGs, epoch stamps from TUM_T0, ground truth at
# twice the frame rate TUM_GT_OFFSET s late, as tests/test_dataset_e2e.py
# writes them), the bench arc at EuRoC cam0's 752x480 and focal lengths as
# a mav0 tree (8-bit gray PNGs, ns stamps from EUROC_T0), both tracked at
# the flagship ORB and map with an ATE of at most DATASET_MAX_ATE m
# against the ground truth parsed from disk (test_slam_from_disk's bar);
# examples/run_dataset_torch.py over EXAMPLE_FRAMES frames of the TUM
# tree; and tests/test_stress_e2e.py's flagship lap on the textured room.
TUM_T0, TUM_GT_OFFSET = 1305031102.0, 0.003
EUROC_T0 = 1403636579.0
EUROC_W, EUROC_H, EUROC_FX, EUROC_FY = 752, 480, 458.654, 457.296
DATASET_MAX_ATE = 0.25
TUM_FILTERS = (0, 1, 2, 3, 4)   # PNG row filters, cycled (every kind)
EUROC_FILTERS = (0, 1, 2)       # no Average or Paeth rows
EXAMPLE_FRAMES = 30
TEXTURED_FRAMES, TEXTURED_MIN_OK, TEXTURED_MAX_ATE = 120, 90, 0.15
TEXTURED_KNOBS = dict(noise_sigma=2.5, gain_jitter=0.03, blur_sigma=0.5,
                      vignette=0.25, occluder=0.3, exposure_step_every=30,
                      exposure_step=0.18, rolling_shutter=0.5, rs_bands=8,
                      fg_boxes=2)
OFFLINE_THREADS = 2             # the offline process's CPU threads
# dataset_tum's positions against the main path's, frame for frame: the
# same images, so the same trajectory up to the stamps' rounding.
OFFLINE_POS_TOL = 1e-4
# The calibration phase: tests/test_calibration.py's boards (a 9x6
# inner-corner pattern of 25 mm squares) in CALIB_VIEWS views at 640x480
# under its camera; card and CPU corners within CALIB_CORNER_TOL px, K
# within CALIB_K_REL, fx and fy within CALIB_F_REL of the truth (that
# test's bar); then PANEL_FRAMES JPEG frames of /panel sent back as the
# calibration upload, the boards replayed at PANEL_FPS.
CALIB_PATTERN, CALIB_SQUARE, CALIB_VIEWS = (9, 6), 25.0, 12
CALIB_K = np.array([[520.0, 0.0, 322.0], [0.0, 515.0, 238.0],
                    [0.0, 0.0, 1.0]])
CALIB_DIST = np.array([0.08, -0.15, 0.001, -0.0005, 0.0])
CALIB_CORNER_TOL, CALIB_K_REL, CALIB_F_REL = 1e-3, 1e-4, 0.02
PANEL_FRAMES, PANEL_FPS = 10, 10.0
LANES_THREADS = 3               # the lanes process's CPU threads
RING_THREADS = 1                # the ring process's (its steps are host-bound)
# Steps timed in the served replay of the main path (phase 6).
REPLAY_TIMED = ("_backfill_step", "_wide_slice", "_young_slice")
LOOP_PROGRAMS = ("_loop_candidate", "_loop_sim3", "_loop_apply",
                 "_global_slice")
# H100 SXM (NVIDIA data sheet): HBM bandwidth, and fp32 outside the
# tensor cores, 67 TFLOP/s = 132 SMs x 128 lanes x 2 (an FMA) x 1.98 GHz.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# Issue rates of the instructions the FAST kernel runs (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0): a float add or subtract 128 results per clock per SM,
# a compare, min, max or select 64; an SM issues at most 128 per clock.
SUB_OPS_S = PEAK_FP32_S / 2
CMP_OPS_S = PEAK_FP32_S / 4
INSTR_OPS_S = PEAK_FP32_S / 2
# The earlier one-pixel-per-thread formulation's count, 424 operations
# per pixel at 67 TFLOP/s; printed beside the bound for comparison.
OLD_OPS_PER_PIXEL = 424
SPIN_CYCLES = 100_000_000       # ~50 ms at the H100's 1.98 GHz SM clock


_CHILDREN = []                  # processes this run started


def _stop_children():
    """Kill every child still running, with the processes it started
    (start_child makes each the leader of a process group), then reap
    each for at most 10 s (a process killed inside a CUDA call may take a
    while to go)."""
    running = [c for c in _CHILDREN if c.poll() is None]
    for child in running:
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            child.kill()
    for child in running:
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _watchdog(signum, frame):
    print(f"chip_smoke: watchdog fired after {WATCHDOG_S} s", file=sys.stderr,
          flush=True)
    _stop_children()
    os._exit(3)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """uint8-valued textured image: random boxes over mild noise."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(20, 60, (h, w))
    for _ in range(max(40, h * w // 600)):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        img[y:y + rng.integers(3, 12), x:x + rng.integers(3, 12)] = \
            rng.uniform(40, 250)
    return np.round(img).astype(np.uint8).astype(np.float32)


def cuda_ms(fn, n: int, repeats: int = 5, queued: bool = True) -> float:
    """Median over ``repeats`` of the mean per-call time of ``n`` calls,
    by CUDA events. ``queued``: a ~50 ms spin kernel runs first, so the
    host enqueues all ``n`` calls while the card is busy and the events
    time the calls back to back on the device (device time, without the
    host's launch gaps); otherwise the time includes those gaps (the
    interval between launches that an eager caller pays)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def host_ms(fn, n: int = 200) -> float:
    """Host time per call of ``fn`` (issue only; one sync at the end)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def ptxas_summary(report: str):
    """Registers, shared memory, spills and stack of each kernel in
    nvcc's -Xptxas -v report."""
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(kernel=m.group(1))
            out.append(cur)
        elif cur is not None:
            for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
    return out


def equal_or_fail(got, ref, what):
    """torch.equal(got, ref), or fail naming the case."""
    if not got.equal(ref):
        err = (float((got - ref).abs().max()) if got.shape == ref.shape
               else f"shapes {tuple(got.shape)} and {tuple(ref.shape)}")
        fail(f"FAST kernel differs from its plain version: {what} "
             f"(max abs diff {err})")


def kernel_check(torch, fast_cuda, fast_ops, level_shapes):
    """Phase 2: the CUDA kernel against the plain version on the card,
    bit for bit (torch.equal)."""
    dev = torch.device("cuda")
    shapes = list(level_shapes(480, 640, 8, 1.2))
    cases = 0
    for i, (h, w) in enumerate(shapes + [(100, 128), (7, 9)]):
        img = torch.from_numpy(texture(h, w, seed=i)).to(dev)
        for th in (7.0, 20.0):
            raw, nms = fast_cuda.fast_score_cuda(img, th, with_nms=True)
            raw_only = fast_cuda.fast_score_cuda(img, th)
            ref = fast_ops.fast_score_map(img, th)
            ref_nms = fast_ops.nms3x3(ref)
            equal_or_fail(raw, ref, f"raw {h}x{w} th={th}")
            equal_or_fail(nms, ref_nms, f"nms {h}x{w} th={th}")
            equal_or_fail(raw_only, ref, f"raw-only {h}x{w} th={th}")
            if h >= 100 and int((ref_nms > 0).sum()) == 0:
                fail(f"texture {h}x{w} th={th} has no corners to check")
            cases += 1
    for (h, w) in ((225, 300), (100, 128)):
        batch = torch.stack([torch.from_numpy(texture(h, w, seed=50 + s))
                             for s in range(3)]).to(dev)
        for th in (7.0, 20.0):
            raw_b, nms_b = fast_cuda.fast_score_cuda(batch, th, with_nms=True)
            for r in range(3):
                raw_1, nms_1 = fast_cuda.fast_score_cuda(
                    batch[r].contiguous(), th, with_nms=True)
                equal_or_fail(raw_b[r], raw_1, f"batch row {r} {h}x{w} raw")
                equal_or_fail(nms_b[r], nms_1, f"batch row {r} {h}x{w} nms")
                ref = fast_ops.fast_score_map(batch[r], th)
                equal_or_fail(raw_b[r], ref, f"batch row {r} {h}x{w} vs plain")
                equal_or_fail(nms_b[r], fast_ops.nms3x3(ref),
                              f"batch row {r} {h}x{w} nms vs plain")
            cases += 1

    # One launch over the whole pyramid, raw-only and with NMS.
    pyr = [torch.from_numpy(texture(h, w, seed=i)).to(dev)
           for i, (h, w) in enumerate(shapes)]
    max_err = 0.0
    for th in (7.0, 20.0):
        refs = [fast_ops.fast_score_map(lv, th) for lv in pyr]
        for with_nms in (False, True):
            n0 = fast_cuda.launches
            got = fast_cuda.fast_score_levels_cuda(pyr, th, with_nms)
            if fast_cuda.launches != n0 + 1:
                fail("a pyramid call did not count exactly one launch")
            for (h, w), out, ref in zip(shapes, got, refs):
                raw = out[0] if with_nms else out
                equal_or_fail(raw, ref, f"pyramid raw {h}x{w} th={th}")
                max_err = max(max_err, float((raw - ref).abs().max()))
                if with_nms:
                    equal_or_fail(out[1], fast_ops.nms3x3(ref),
                                  f"pyramid nms {h}x{w} th={th}")
            cases += 1
    # 8 lanes x 8 levels in one launch: each row equals its own launch.
    lanes = [torch.stack([torch.from_numpy(texture(h, w, seed=100 * s + i))
                          for s in range(8)]).to(dev)
             for i, (h, w) in enumerate(shapes)]
    got = fast_cuda.fast_score_levels_cuda(lanes, 7.0, with_nms=True)
    for r in range(8):
        one = fast_cuda.fast_score_levels_cuda(
            [lv[r].contiguous() for lv in lanes], 7.0, with_nms=True)
        for (h, w), lv, (raw_b, nms_b), (raw_1, nms_1) in zip(
                shapes, lanes, got, one):
            equal_or_fail(raw_b[r], raw_1, f"lane {r} raw {h}x{w}")
            equal_or_fail(nms_b[r], nms_1, f"lane {r} nms {h}x{w}")
            ref = fast_ops.fast_score_map(lv[r], 7.0)
            equal_or_fail(raw_1, ref, f"lane {r} raw {h}x{w} vs plain")
            equal_or_fail(nms_1, fast_ops.nms3x3(ref),
                          f"lane {r} nms {h}x{w} vs plain")
    cases += 1
    # Other scales' pyramids (odd level shapes: 369x492, 284x379, ... at
    # 1.3), resampled from a textured frame as build_pyramid resamples
    # them: one launch over every level, raw and with NMS.
    from send_slam_tpu_torch.ops.pyramid import build_pyramid
    odd = {}
    for scale in ODD_SCALES:
        pyr = build_pyramid(torch.from_numpy(texture(480, 640, seed=70))
                            .to(dev), 8, scale)
        odd[str(scale)] = [list(lv.shape) for lv in pyr]
        for th in (7.0, 20.0):
            got = fast_cuda.fast_score_levels_cuda(pyr, th, with_nms=True)
            for lv, (raw, nms) in zip(pyr, got):
                ref = fast_ops.fast_score_map(lv, th)
                what = f"scale {scale} level {tuple(lv.shape)} th={th}"
                equal_or_fail(raw, ref, f"raw, {what}")
                equal_or_fail(nms, fast_ops.nms3x3(ref), f"nms, {what}")
                max_err = max(max_err, float((raw - ref).abs().max()))
            cases += 1
    # dataset_euroc's pyramid: 752x480 at 1.2 (480x752, 400x625, ...,
    # 125x200), one launch over every level, raw and with NMS.
    euroc = build_pyramid(torch.from_numpy(texture(EUROC_H, EUROC_W,
                                                   seed=80)).to(dev), 8, 1.2)
    for th in (7.0, 20.0):
        got = fast_cuda.fast_score_levels_cuda(euroc, th, with_nms=True)
        for lv, (raw, nms) in zip(euroc, got):
            ref = fast_ops.fast_score_map(lv, th)
            what = f"752x480 level {tuple(lv.shape)} th={th}"
            equal_or_fail(raw, ref, f"raw, {what}")
            equal_or_fail(nms, fast_ops.nms3x3(ref), f"nms, {what}")
            max_err = max(max_err, float((raw - ref).abs().max()))
        cases += 1
    # Each lanes path's launch at its own batch, levels and data.
    lanes_err = 0.0
    for name, (levels, th) in lanes_launch_inputs(torch).items():
        got = fast_cuda.fast_score_levels_cuda(levels, th, with_nms=True)
        lanes_err = max(lanes_err, hold_launch(fast_ops, levels, th, got,
                                               f"{name}'s launch"))
        cases += 1
    torch.cuda.synchronize()
    return dict(cases=cases, comparison="torch.equal", max_abs_err=max_err,
                lanes_max_abs_err=lanes_err, odd_scale_level_shapes=odd,
                euroc_level_shapes=[list(lv.shape) for lv in euroc])


def hold_launch(fast_ops, levels, th, got, what):
    """A batched launch's (raw, nms) per level against the plain version
    on each of its rows, bit for bit; the largest difference."""
    err = 0.0
    for lvl, (lv, (raw, nms)) in enumerate(zip(levels, got)):
        for r in range(lv.shape[0]):
            ref = fast_ops.fast_score_map(lv[r], th)
            equal_or_fail(raw[r], ref, f"{what}, lane {r} level {lvl} raw")
            equal_or_fail(nms[r], fast_ops.nms3x3(ref),
                          f"{what}, lane {r} level {lvl} nms")
            err = max(err, float((raw[r] - ref).abs().max()))
    return err


def lanes_launch_inputs(torch):
    """The levels of one FAST launch of each lanes path, stacked as
    extract_orb_batch stacks them: lanes_path's 2 flagship lanes (its
    uint8 renders) at the merge step, and lanes_ring's 8 lanes at
    160x120 (its float renders) half-way. {name: (levels, threshold)}."""
    from send_slam_tpu_torch.ops.pyramid import build_pyramid
    world, _, poses, _ = lanes_scene()
    k = LANES_MERGE_AFTER
    pair = np.stack([np.round(world.render(*poses[c][k])).astype(np.uint8)
                     for c in range(2)]).astype(np.float32)
    rworld, rcfg, centres = ring_scene()
    ring = np.stack([rworld.render(np.eye(3), -centres[c][RING_STEPS // 2])
                     for c in range(RING_LANES)]).astype(np.float32)
    out = {}
    for name, imgs, orb in (("lanes_path", pair, flagship_config().orb),
                            ("lanes_ring", ring, rcfg.orb)):
        pyrs = [build_pyramid(torch.from_numpy(im).cuda(), orb.n_levels,
                              orb.scale_factor) for im in imgs]
        out[name] = ([torch.stack([p[lvl] for p in pyrs])
                      for lvl in range(orb.n_levels)],
                     float(orb.min_th_fast))
    return out


def fast_work(torch, fast_ops, levels, th):
    """What FAST with NMS must do on ``levels`` (each (..., H, W)) at
    threshold ``th``, as csrc/fast_kernel.cu formulates it: pixels,
    pixels that pass the compass pre-test (points 0, 4, 8, 12), and
    corners (raw score > 0)."""
    n_px = n_cand = n_corner = 0
    for lv in levels:
        H, W = lv.shape[-2:]
        p = fast_ops._pad2d(lv, 3, "replicate")
        c4 = torch.stack([p[..., 3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W]
                          for dx, dy in (fast_ops.CIRCLE_OFFSETS[j]
                                         for j in (0, 4, 8, 12))]) - lv
        b, k = c4 > th, c4 < -th
        cand = ((b & b.roll(-1, 0)) | (k & k.roll(-1, 0))).any(0)
        n_px += lv.numel()
        n_cand += int(cand.sum())
        n_corner += int((fast_ops.fast_score_map(lv, th) > 0).sum())
    return n_px, n_cand, n_corner


def fast_bound(n_px, n_cand, n_corner):
    """The least time (ms) the card could take for FAST with NMS on
    inputs with these counts (fast_work), and what bounds it. Bytes:
    the image read once, the raw and NMS maps written once. Operations,
    per pixel: the pre-test's 4 subtractions and 8 compares and the NMS
    select; per pixel that passes it, 12 more subtractions and 161
    min/max/compare/select (3 x 32 for the arcs of 2, 4 and 8, 32 for
    the arcs of 9, 30 to reduce the 16 arcs per side, one max, one
    compare, one select); per corner, the 8 NMS compares. Loads,
    addresses and predicate logic are not counted."""
    subs = 4 * n_px + 12 * n_cand
    cmps = 9 * n_px + 161 * n_cand + 8 * n_corner
    t_bytes = 3 * 4 * n_px / PEAK_BYTES_S * 1e3
    t_ops = max(subs / SUB_OPS_S, cmps / CMP_OPS_S,
                (subs + cmps) / INSTR_OPS_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
                subtractions=subs, compare_min_max_select=cmps,
                pixels=n_px, pretest_passes=n_cand, corners=n_corner)


def kernel_times(torch, fast_cuda, fast_ops, level_shapes, bench_pyr):
    """Phase 3: times per 640x480 frame (8 levels, raw + NMS at
    min_th_fast = 7), the batch of 8 pyramids, and the bounds of each
    timed input; ``bench_pyr`` is the pyramid of a bench-scene frame
    (the main path's own data)."""
    dev = torch.device("cuda")
    shapes = list(level_shapes(480, 640, 8, 1.2))
    pyr = [torch.from_numpy(texture(h, w, seed=i)).to(dev)
           for i, (h, w) in enumerate(shapes)]

    def one_launch():
        fast_cuda.fast_score_levels_cuda(pyr, 7.0, with_nms=True)

    def eight_launches():
        for lv in pyr:
            fast_cuda.fast_score_cuda(lv, 7.0, with_nms=True)

    def plain():
        for lv in pyr:
            fast_ops.nms3x3(fast_ops.fast_score_map(lv, 7.0))

    ms = cuda_ms(one_launch, 50)
    launch_ms = cuda_ms(one_launch, 50, queued=False)
    launch_host_ms = host_ms(one_launch)
    bench_ms = cuda_ms(lambda: fast_cuda.fast_score_levels_cuda(
        bench_pyr, 7.0, with_nms=True), 50)
    eight_ms = cuda_ms(eight_launches, 20)
    eight_launch_ms = cuda_ms(eight_launches, 20, queued=False)
    plain_ms = cuda_ms(plain, 5, repeats=3)
    bound = fast_bound(*fast_work(torch, fast_ops, pyr, 7.0))
    n_px = bound["pixels"]
    old_ops_bound_ms = OLD_OPS_PER_PIXEL * n_px / PEAK_FP32_S * 1e3
    if ms < old_ops_bound_ms:
        print(f"FAST: one launch per frame takes {ms:.5f} ms, under the "
              f"one-pixel-per-thread formulation's {OLD_OPS_PER_PIXEL}-"
              f"operation bound of {old_ops_bound_ms:.5f} ms: this "
              "formulation does fewer operations.", flush=True)

    lanes = [torch.stack([torch.from_numpy(texture(h, w, seed=100 * s + i))
                          for s in range(8)]).to(dev)
             for i, (h, w) in enumerate(shapes)]
    batch_ms = cuda_ms(lambda: fast_cuda.fast_score_levels_cuda(
        lanes, 7.0, with_nms=True), 20)
    batch_bound = fast_bound(*fast_work(torch, fast_ops, lanes, 7.0))
    bench_bound = fast_bound(*fast_work(torch, fast_ops, bench_pyr, 7.0))
    # Two lanes (phase 15's launch) and the plain version on both batches.
    pair = [lv[:2].contiguous() for lv in lanes]
    hold_launch(fast_ops, pair, 7.0, fast_cuda.fast_score_levels_cuda(
        pair, 7.0, with_nms=True), "the timed 2-lane launch")
    pair_ms = cuda_ms(lambda: fast_cuda.fast_score_levels_cuda(
        pair, 7.0, with_nms=True), 20)
    pair_bound = fast_bound(*fast_work(torch, fast_ops, pair, 7.0))

    def plain_levels(levels):
        for lv in levels:
            fast_ops.nms3x3(fast_ops.fast_score_map(lv, 7.0))

    pair_plain_ms = cuda_ms(lambda: plain_levels(pair), 5, repeats=3)
    batch_plain_ms = cuda_ms(lambda: plain_levels(lanes), 3, repeats=3)
    # scale_path's launch: a 640x480 frame's 8 levels at 1.3.
    from send_slam_tpu_torch.ops.pyramid import build_pyramid
    odd = build_pyramid(torch.from_numpy(texture(480, 640, seed=70)).to(dev),
                        8, SCALE_PATH_SCALE)
    odd_ms = cuda_ms(lambda: fast_cuda.fast_score_levels_cuda(
        odd, 7.0, with_nms=True), 50)
    odd_plain_ms = cuda_ms(lambda: plain_levels(odd), 5, repeats=3)
    odd_bound = fast_bound(*fast_work(torch, fast_ops, odd, 7.0))
    # dataset_euroc's launch: a 752x480 frame's 8 levels at 1.2.
    euroc = build_pyramid(torch.from_numpy(texture(EUROC_H, EUROC_W,
                                                   seed=80)).to(dev), 8, 1.2)
    euroc_ms = cuda_ms(lambda: fast_cuda.fast_score_levels_cuda(
        euroc, 7.0, with_nms=True), 50)
    euroc_plain_ms = cuda_ms(lambda: plain_levels(euroc), 5, repeats=3)
    euroc_bound = fast_bound(*fast_work(torch, fast_ops, euroc, 7.0))
    return dict(
        unit="per 640x480 frame: 8 pyramid levels, raw + NMS at th 7",
        tile=[fast_cuda.TILE_W, fast_cuda.TILE_H],
        ms=ms, launch_interval_ms=launch_ms, launch_host_ms=launch_host_ms,
        eight_launches_ms=eight_ms,
        eight_launches_interval_ms=eight_launch_ms,
        plain_ms=plain_ms, **bound, old_ops_bound_ms=old_ops_bound_ms,
        bench_scene=dict(ms=bench_ms, **bench_bound),
        batch=dict(lanes=8, levels=8, ms=batch_ms, plain_ms=batch_plain_ms,
                   **batch_bound),
        pair=dict(lanes=2, levels=8, ms=pair_ms, plain_ms=pair_plain_ms,
                  **pair_bound),
        scale_1_3=dict(levels=[list(lv.shape) for lv in odd], ms=odd_ms,
                       plain_ms=odd_plain_ms, **odd_bound),
        euroc_752x480=dict(levels=[list(lv.shape) for lv in euroc],
                           ms=euroc_ms, plain_ms=euroc_plain_ms,
                           **euroc_bound))


def frontend_check(torch, make_frame, cfg, img):
    """Phase 3: make_frame on the card vs the plain path on the CPU."""
    gpu = make_frame(img, 0.0, cfg.orb, cfg.camera, device="cuda")
    cpu = make_frame(img, 0.0, cfg.orb, cfg.camera, device="cpu")
    g = {k: v.cpu() for k, v in gpu.feat._asdict().items()}
    c = cpu.feat._asdict()
    for k in ("valid", "octave", "response"):
        if not torch.equal(g[k], c[k]):
            fail(f"make_frame on the card differs from the CPU in {k}")
    uv_err = float((g["uv"] - c["uv"]).abs().max())
    valid = c["valid"]
    desc_rows = int(((g["desc"] != c["desc"]).any(1) & valid).sum())
    n_valid = int(valid.sum())
    if not (uv_err <= 1e-4 and desc_rows <= 0.01 * n_valid and n_valid > 500):
        fail(f"make_frame on the card: uv err {uv_err}, {desc_rows} of "
             f"{n_valid} descriptors differ")
    return dict(n_valid=n_valid, uv_max_abs_err=uv_err,
                desc_rows_differing=desc_rows)


def drive(torch, system, frames, ts, after_frame=None, stop=None):
    """Feed the frames (until ``stop(k, system)`` says so) and drain at
    shutdown; count poses as bench.py does (live OK outputs, backfill
    triples, the shutdown drain). Returns the emitted (timestamp,
    position, orientation) list in emission order, the time-ordered
    estimate, each frame's tracking state, the per-frame ms of live
    OK frames (each frame ends in a device sync) and ``wire``, the
    triples a backend sends for these frames in its order (no shutdown
    drain)."""
    from send_slam_tpu_torch.models.system import TRACKING_OK
    emitted, t_ok, live, backfilled, states = [], [], 0, 0, []
    wire = []
    t_run = time.perf_counter()

    def take(out):
        nonlocal live, backfilled
        if out.tracking_state == TRACKING_OK:
            live += 1
            emitted.append((out.timestamp, out.position, out.orientation))
        backfilled += len(out.backfill)
        emitted.extend(out.backfill)

    for k in range(len(frames)):
        img = frames[k]
        t0 = time.perf_counter()
        out = system.track_monocular(img, float(ts[k]))
        torch.cuda.synchronize()
        if out.tracking_state == TRACKING_OK:
            t_ok.append((time.perf_counter() - t0) * 1e3)
        take(out)
        # What the backend sends for this frame: the backfill, then the
        # live pose stamped with the frame's own timestamp.
        wire.extend(out.backfill)
        if out.tracking_state == TRACKING_OK:
            wire.append((float(ts[k]), out.position, out.orientation))
        states.append(out.tracking_state)
        if after_frame is not None:
            after_frame(k, system)
        if stop is not None and stop(k, system):
            break
    for out in system.shutdown():
        take(out)
    torch.cuda.synchronize()
    order = np.argsort(np.asarray([e[0] for e in emitted]), kind="stable")
    return dict(emitted=emitted, live=live, backfilled=backfilled, t_ok=t_ok,
                states=states, wire=wire,
                est_ts=[emitted[i][0] for i in order],
                est_pos=np.asarray([emitted[i][1] for i in order],
                                   np.float64).reshape(-1, 3),
                keyframes=int(system._n_kf_host),
                landmarks=int(system.map.n_landmarks()),
                polish_slices=dict(system.polish_slices_run),
                seconds=time.perf_counter() - t_run)


def time_calls(torch, system, names):
    """Wrap each of ``names`` on this System so every call ends in a
    device sync and its wall ms is appended to the returned lists
    (numerics unchanged)."""
    times = {n: [] for n in names}
    for n in names:
        fn = getattr(system, n)

        def timed(*a, _fn=fn, _n=n, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_n].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(system, n, timed)
    return times


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _tree_to(torch, x, dev):
    """Tensors of a (nested) NamedTuple moved to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [_tree_to(torch, v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def keep_ba_inputs(torch, system):
    """Keep, on the CPU, the inputs of the main path's first init commit
    (``bootstrap_map``: its 10-iteration BA with one keyframe fixed) and
    of its first keyframe insertion that a local BA follows (the map
    then holds at least two keyframes), for step_parity."""
    from send_slam_tpu_torch.models import system as sysmod
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    kept = {}
    boot = system._bootstrap_map
    insert = sysmod.insert_keyframe_with_triangulation

    def keep_boot(m, fa, fb, init_res):
        if "bootstrap" not in kept:
            kept["bootstrap"] = (map_to_numpy(m), *(
                _tree_to(torch, x, "cpu") for x in (fa, fb, init_res)))
        return boot(m, fa, fb, init_res)

    def keep_insert(m, *args, **kw):
        if "keyframe" not in kept and int(m.n_kf) >= 2:
            kept["keyframe"] = (map_to_numpy(m), _tree_to(torch, args, "cpu"),
                                {k: _tree_to(torch, v, "cpu")
                                 for k, v in kw.items()})
        return insert(m, *args, **kw)

    system._bootstrap_map = keep_boot
    sysmod.insert_keyframe_with_triangulation = keep_insert
    try:
        yield kept
    finally:
        del system._bootstrap_map
        sysmod.insert_keyframe_with_triangulation = insert


def _diff_fields(a, b):
    """Per field of two numpy maps that differ: the largest absolute
    difference (floats) or the number of differing entries."""
    return {f: (_max_err(a[f], b[f]) if a[f].dtype.kind == "f"
                else int((a[f] != b[f]).sum()))
            for f in a if not np.array_equal(a[f], b[f])}


def ba_parity(torch, cfg, kept):
    """C.1: the main path's init commit (``bootstrap_map``) and its first
    keyframe insertion with the local BA that follows it (as
    ``System._frame_step`` runs them), from the same kept inputs on the
    card and on the CPU: each written field's largest difference, the
    fields of BA_TOL held at it (absolute) and every other field equal
    within 1e-6 of its largest magnitude (integers exact)."""
    from send_slam_tpu_torch.models.covisibility import covis_window_ids
    from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
    from send_slam_tpu_torch.models.local_mapping import (
        bootstrap_map, insert_keyframe_with_triangulation,
    )
    from send_slam_tpu_torch.models.map_state import (
        map_from_numpy, map_to_numpy,
    )
    tr = cfg.tracking
    K = torch.tensor([[cfg.camera.fx, 0.0, cfg.camera.cx],
                      [0.0, cfg.camera.fy, cfg.camera.cy],
                      [0.0, 0.0, 1.0]], dtype=torch.float32)
    out = {}
    for name in ("bootstrap", "keyframe"):
        if name not in kept:
            fail(f"step_parity: the main path ran no {name} step to hold")
        maps = {}
        for dev in ("cuda", "cpu"):
            m = map_from_numpy(kept[name][0], device=dev)
            Kd = K.to(dev)
            if name == "bootstrap":
                fa, fb, init_res = (_tree_to(torch, x, dev)
                                    for x in kept[name][1:])
                m = bootstrap_map(m, fa, fb, init_res, Kd, cfg)
            else:
                args = _tree_to(torch, kept[name][1], dev)
                kw = {k: _tree_to(torch, v, dev)
                      for k, v in kept[name][2].items()}
                args = (*args[:5], Kd, *args[6:])
                m, _, _ = insert_keyframe_with_triangulation(m, *args, **kw)
                if int(m.n_kf) >= 3:
                    m = local_bundle_adjustment(
                        m, Kd, cfg.map, iters=tr.kf_insert_ba_iters,
                        damping=tr.ba_slice_damping,
                        window_ids=covis_window_ids(m, cfg.map.ba_window)[0],
                        prune=True)
            maps[dev] = map_to_numpy(m)
        g, c = maps["cuda"], maps["cpu"]
        ba_err = {f: _max_err(g[f], c[f]) for f in BA_TOL}
        rest = [f for f in c if f not in BA_TOL]
        same, rel = _np_fields_close({f: g[f] for f in rest},
                                     {f: c[f] for f in rest}, 1e-6)
        out[name] = dict(
            n_kf=int(c["n_kf"]), differing=_diff_fields(g, c),
            ba_fields_abs_err=ba_err,
            ba_fields_share_of_bar={f: ba_err[f] / BA_TOL[f]
                                    for f in BA_TOL},
            other_fields_rel_err=rel, other_fields_equal=bool(same))
        if not same or any(ba_err[f] > BA_TOL[f] for f in BA_TOL):
            fail(f"step_parity: {name} card vs CPU beyond BA_TOL or the "
                 f"1e-6 bar: {out[name]}")
    return out


def step_parity(torch, System, cfg, snaps, frames, ts, kept_ba):
    """Phase 7 (ROADMAP C.2): from the card's carried state at each
    snapshot, the frame step, a wide and a young polish slice and the
    relocalization step on the card and on the CPU, compared."""
    from send_slam_tpu_torch.models.map_state import (
        map_from_numpy, map_to_numpy,
    )
    from send_slam_tpu_torch.models.initializer import sample_minimal_sets
    from send_slam_tpu_torch.models.relocalize import reloc_matches
    from send_slam_tpu_torch.models.system import (
        S_INLIERS, S_KF, S_NKF, loop_state_from_numpy,
    )
    sides = dict(cuda=System(cfg, device="cuda"),
                 cpu=System(cfg, device="cpu"))
    card_ms = time_calls(torch, sides["cuda"], ("_frame_step", "_wide_slice",
                                                "_young_slice", "_reloc_step"))
    worst = dict(frame_pose=0.0, frame_inliers=0, polish=0.0, reloc_pose=0.0,
                 reloc_inliers=0)
    checks = []
    for snap in snaps:
        k = snap["k"]
        ts_next = float(ts[k + 1]) - snap["t0"]
        res = {}
        for dev, s in sides.items():
            m = map_from_numpy(snap["map"], device=s.device)
            st = loop_state_from_numpy(snap["st"], device=s.device)
            t0 = time.perf_counter()
            _, st2, summ = s._frame_step(m, st, frames[k + 1], ts_next)
            summ = summ.cpu().numpy()
            t_step = time.perf_counter() - t0
            pol = {}
            for kind in ("wide", "young"):
                m2, _, _, big = getattr(s, f"_{kind}_slice")(m, 1e-3, False)
                pol[kind] = (map_to_numpy(m2), bool(big))
            img = frames[k - 5]
            frame = s._make_frame(img, float(ts[k - 5]) - snap["t0"])
            if s.device.type == "cpu":
                mm = reloc_matches(m.lm_desc, frame.feat.desc, m.lm_valid,
                                   frame.feat.valid, cfg.tracking)
                g = torch.Generator().manual_seed(k)
                idx = sample_minimal_sets(g, mm.valid, 256, 6)
            res[dev] = dict(st=st2, summ=summ, pol=pol, t_step=t_step,
                            frame=frame)
        for dev, s in sides.items():
            m = map_from_numpy(snap["map"], device=s.device)
            out, _ = s._reloc_step(m, res[dev]["frame"], sample_idx=idx)
            res[dev]["reloc"] = (out.R.cpu().numpy(), out.t.cpu().numpy(),
                                 int(out.n_inliers), bool(out.use_pnp))
        g, c = res["cuda"], res["cpu"]
        e_pose = max(_max_err(g["st"].R.cpu(), c["st"].R),
                     _max_err(g["st"].t.cpu(), c["st"].t))
        d_inl = abs(int(g["summ"][S_INLIERS]) - int(c["summ"][S_INLIERS]))
        kf_same = (g["summ"][S_KF] == c["summ"][S_KF]
                   and g["summ"][S_NKF] == c["summ"][S_NKF])
        e_pol, big_same = 0.0, True
        for kind in ("wide", "young"):
            (mg, bg), (mc, bc) = g["pol"][kind], c["pol"][kind]
            big_same &= bg == bc
            for f in ("kf_R", "kf_t", "lm_pos"):
                e_pol = max(e_pol, _max_err(mg[f], mc[f]))
        rg, rc = g["reloc"], c["reloc"]
        e_rel = max(_max_err(rg[0], rc[0]), _max_err(rg[1], rc[1]))
        d_rel = abs(rg[2] - rc[2])
        checks.append(dict(frame=k, pose_err=e_pose, inliers_diff=d_inl,
                           keyframe_decision_equal=bool(kf_same),
                           inserted=bool(c["summ"][S_KF] > 0.5),
                           polish_err=e_pol, big_equal=bool(big_same),
                           reloc_pose_err=e_rel, reloc_inliers=rc[2],
                           reloc_inliers_diff=d_rel,
                           reloc_branch="pnp" if rc[3] else "retrieval",
                           reloc_branch_equal=rg[3] == rc[3],
                           cpu_step_s=c["t_step"]))
        if not (e_pose <= 1e-4 and d_inl <= 2 and kf_same):
            fail(f"frame step at replay frame {k}: card vs CPU pose err "
                 f"{e_pose}, inliers differ by {d_inl}, keyframe decision "
                 f"equal: {kf_same}")
        if not (e_pol <= 1e-3 and big_same):
            fail(f"polish slices at replay frame {k}: card vs CPU err "
                 f"{e_pol}, rebase flag equal: {big_same}")
        if not (e_rel <= 1e-4 and d_rel <= 2 and rg[3] == rc[3]):
            fail(f"relocalization at replay frame {k}: card vs CPU pose err "
                 f"{e_rel}, inliers differ by {d_rel}, branch equal: "
                 f"{rg[3] == rc[3]}")
        worst = dict(frame_pose=max(worst["frame_pose"], e_pose),
                     frame_inliers=max(worst["frame_inliers"], d_inl),
                     polish=max(worst["polish"], e_pol),
                     reloc_pose=max(worst["reloc_pose"], e_rel),
                     reloc_inliers=max(worst["reloc_inliers"], d_rel))
    return dict(tolerances=dict(pose=1e-4, inliers=2, polish=1e-3,
                                ba_fields_abs=BA_TOL),
                worst=worst, checks=checks, card_ms_per_call=card_ms,
                ba=ba_parity(torch, cfg, kept_ba))


def reloc_phase(system, frames, ts, gt, est_ts, est_pos):
    """Phase 8: featureless frames until LOST, then frames of mapped
    territory until TRACKING_OK (at most RELOC_FRAMES of them)."""
    from send_slam_tpu_torch.io.evaluate import associate, umeyama_alignment
    from send_slam_tpu_torch.models.system import (
        TRACKING_LOST, TRACKING_OK,
    )
    tr = system.cfg.tracking
    n_kf = int(system._n_kf_host)
    if n_kf < 6:
        fail(f"the main run made {n_kf} keyframes; relocalization needs 6")
    blank = np.full_like(frames[0], 20)
    t = float(ts[-1])
    dt = float(ts[1] - ts[0])
    n_blank = 0
    while system.state != TRACKING_LOST:
        n_blank += 1
        t += dt
        system.track_monocular(blank, t)
        if n_blank > 40:
            fail("40 featureless frames did not make the System LOST")
    ia, ib = associate(np.asarray(est_ts), np.asarray(ts))
    s_al, R_al, t_al = umeyama_alignment(est_pos[ia], gt[ib])
    first = len(frames) // 3
    for i in range(RELOC_FRAMES):
        j = first + 3 * i
        t += dt
        t0 = time.perf_counter()
        out = system.track_monocular(frames[j], t)
        ms = (time.perf_counter() - t0) * 1e3
        if system._reloc_failures >= tr.atlas_reloc_patience:
            fail("relocalization reached the atlas patience")
        if out.tracking_state == TRACKING_OK:
            err = float(np.linalg.norm(
                s_al * R_al @ np.asarray(out.position, np.float64) + t_al
                - gt[j]))
            return dict(keyframes=n_kf, blank_frames=n_blank,
                        frames_to_recover=i + 1, frame_index=j,
                        aligned_position_err_m=err,
                        branch=system.last_reloc["branch"],
                        inliers=system.last_reloc["inliers"],
                        reloc_frame_ms=ms,
                        reloc_failures=system._reloc_failures)
    fail(f"not relocalized within {RELOC_FRAMES} frames of mapped territory "
         f"(last attempt: {system.last_reloc})")



class Rendered:
    """Frames of a trajectory of (R, t) poses, rendered to uint8 on first
    use (a 640x480 render takes tens of ms on the host); a pose of None
    is a black frame."""

    def __init__(self, world, poses):
        self.world, self.poses = world, list(poses)
        self._cache = {}

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, k):
        if k not in self._cache:
            pose = self.poses[k]
            self._cache[k] = (
                np.zeros((self.world.H, self.world.W), np.uint8)
                if pose is None else
                np.round(self.world.render(*pose)).astype(np.uint8))
        return self._cache[k]


def kf_ate(system, ts, gt):
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    kts, kpos, _ = system.keyframe_poses()
    return ate_rmse(kts, kpos, ts, gt) if len(kts) >= 3 else float("inf")


def loop_path(torch, System, cfg, fast_cuda):
    """Phase 10: the revisit session on the card, with the loop programs
    timed and the inputs of the first verified closure, its apply and
    its first global slice kept for loop_parity."""
    from send_slam_tpu_torch.io.evaluate import (
        associate, ate_rmse, umeyama_alignment,
    )
    from send_slam_tpu_torch.models.system import TRACKING_OK
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory_laps(n_frames=LOOP_TRAJ_FRAMES,
                                        laps=LOOP_LAPS)
    ts, Rs, tls = ts[:LOOP_FRAMES_MAX], Rs[:LOOP_FRAMES_MAX], \
        tls[:LOOP_FRAMES_MAX]
    frames = Rendered(world, zip(Rs, tls))
    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])

    system = System(cfg, device="cuda")
    ms = time_calls(torch, system, LOOP_PROGRAMS)
    keep = dict(sim3=[], apply=None, slice=None, peaks=[])
    frame_now = [0]

    def wrap(name, fn):
        def call(*a):
            if name == "_loop_apply" and keep["apply"] is None:
                keep["apply"] = dict(args=a, frame=frame_now[0],
                                     kf_ate_before=kf_ate(system, ts, gt))
            if name == "_global_slice":
                if keep["slice"] is None:
                    keep["slice"] = dict(args=a, frame=frame_now[0])
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            out = fn(*a)
            if name == "_global_slice":
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                keep["peaks"].append(dict(peak_bytes=peak,
                                          above_base_bytes=peak - base))
            if name == "_loop_sim3":
                keep["sim3"].append(dict(args=a, out=out,
                                         frame=frame_now[0]))
            return out
        return call

    for n in ("_loop_sim3", "_loop_apply", "_global_slice"):
        setattr(system, n, wrap(n, getattr(system, n)))

    attempts = []

    def after_frame(k, s):
        frame_now[0] = k + 1
        while len(attempts) < len(s.loop_attempts):
            attempts.append(dict(frame=k, attempt=list(
                s.loop_attempts[len(attempts)])))

    def stop(k, s):
        return k + 1 >= LOOP_FRAMES and s.loops_closed > 0

    fast_cuda.launches = 0
    system.frames_extracted = 0
    run = drive(torch, system, frames, ts, after_frame=after_frame,
                stop=stop)
    launches, n_extracted = fast_cuda.launches, system.frames_extracted
    n_run = len(run["states"])
    applied = [a for a in attempts if a["attempt"][3] is True]
    est_ts, pos = run["est_ts"], run["est_pos"]
    ia, ib = associate(np.asarray(est_ts), ts[:n_run])
    res = dict(
        phase="loop_path",
        scene=f"SyntheticWorld(n_points=900, 640x480, fx=fy=520, seed=11)."
              f"trajectory_laps(n_frames={LOOP_TRAJ_FRAMES}, "
              f"laps={LOOP_LAPS}), first {n_run} frames",
        frames=n_run, loop_attempts=attempts,
        first_apply_frame=(keep["apply"] or {}).get("frame"),
        first_applied_verdict_frame=applied[0]["frame"] if applied else None,
        loops_closed=system.loops_closed,
        kf_ate_before_first_apply_m=(keep["apply"] or {}).get(
            "kf_ate_before"),
        kf_ate_end_m=kf_ate(system, ts[:n_run], gt[:n_run]),
        streamed_ate_m=(ate_rmse(est_ts, pos, ts[:n_run], gt[:n_run])
                        if len(est_ts) >= 3 else float("inf")),
        # Metres of the scene per map unit (the Sim(3) alignment's scale).
        streamed_sim3_scale=(umeyama_alignment(pos[ia], gt[:n_run][ib])[0]
                             if len(ia) >= 3 else None),
        tracked=len(est_ts), tracked_live=run["live"],
        backfilled=run["backfilled"], tracked_unique=len(set(est_ts)),
        keyframes=run["keyframes"], landmarks=run["landmarks"],
        polish_slices=run["polish_slices"],
        ms_per_call=ms, global_slice_memory=keep["peaks"],
        frames_through_make_frame=n_extracted, fast_launches=launches,
        median_ms_per_tracked_frame=(statistics.median(run["t_ok"][1:])
                                     if len(run["t_ok"]) > 1 else None),
        seconds=run["seconds"])
    if keep["apply"] is not None:
        k0 = keep["apply"]["frame"]
        after = run["states"][k0:]
        res["ok_share_after_first_apply"] = (
            sum(st == TRACKING_OK for st in after) / max(len(after), 1))
    emit(res)
    if launches != n_extracted or launches == 0:
        fail(f"loop path: {launches} FAST launches for {n_extracted} "
             "frames (expected one per make_frame)")
    if not applied:
        fail(f"no loop closure applied in {n_run} frames "
             f"(attempts: {attempts})")
    if run["polish_slices"]["global"] < 8:
        fail(f"{run['polish_slices']['global']} global slices ran after "
             "the closure (expected 8)")
    if res["ok_share_after_first_apply"] < LOOP_MIN_OK_AFTER:
        fail(f"tracking OK on {res['ok_share_after_first_apply']:.2f} of "
             f"the frames after the first apply (< {LOOP_MIN_OK_AFTER})")
    if not (np.isfinite(pos).all() and np.isfinite(res["kf_ate_end_m"])):
        fail("loop path: non-finite trajectory or ATE")
    verified = [c for c in keep["sim3"] if bool(c["out"][0].ok)]
    return res, dict(sim3=verified[0], apply=keep["apply"],
                     slice=keep["slice"])


def _maps_equal(a, b):
    from send_slam_tpu_torch.models.map_state import MapState
    return all(getattr(a, f.name).equal(getattr(b, f.name))
               for f in dataclasses.fields(MapState))


def _rel_err(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-9)


def loop_parity(torch, System, cfg, kept):
    """Phase 11: the loop programs on the card against the CPU from the
    card's state at the first verified closure, and their repeats on
    the card."""
    from send_slam_tpu_torch.models.loop_closing import LoopSim3, N_HYP
    from send_slam_tpu_torch.models.map_state import (
        map_from_numpy, map_to_numpy,
    )
    from send_slam_tpu_torch.models.sim3_solver import (
        Sim3Result, gumbel_noise,
    )
    sides = dict(cuda=System(cfg, device="cuda"),
                 cpu=System(cfg, device="cpu"))
    card_ms = time_calls(torch, sides["cuda"], LOOP_PROGRAMS[1:])
    m_sim3, kf, cands, _ = kept["sim3"]["args"]
    m_sim3 = map_to_numpy(m_sim3)
    cands = cands.cpu()
    noise = gumbel_noise(torch.Generator().manual_seed(7),
                         (cands.shape[0], N_HYP, m_sim3["kf_uv"].shape[1]),
                         "cpu")
    m_apply, kf_a, cand_a, loop = kept["apply"]["args"]
    m_apply = map_to_numpy(m_apply)
    loop_np = [x.cpu() for x in (loop.ok, loop.n_matches)] \
        + [x.cpu() for x in loop.sim3]
    m_slice, lam, prune = kept["slice"]["args"]
    m_slice = map_to_numpy(m_slice)

    out = {}
    for name, s in sides.items():
        dev = s.device
        t0 = time.perf_counter()
        lp, cand = s._loop_sim3(map_from_numpy(m_sim3, device=dev), kf,
                                cands.to(dev), noise.to(dev))
        lp_dev = LoopSim3(ok=loop_np[0].to(dev), n_matches=loop_np[1].to(dev),
                          sim3=Sim3Result(*(x.to(dev) for x in loop_np[2:])))
        m_in = map_from_numpy(m_apply, device=dev)
        ap = s._loop_apply(m_in, kf_a, cand_a.to(dev), lp_dev)
        sl_in = map_from_numpy(m_slice, device=dev)
        sl = s._global_slice(sl_in, lam, prune)
        out[name] = dict(sim3=(lp, cand), apply=ap, slice=sl,
                        seconds=time.perf_counter() - t0,
                        inputs=(m_in, lp_dev, sl_in))
    g, c = out["cuda"], out["cpu"]
    (lg, cg), (lc, cc) = g["sim3"], c["sim3"]
    sim3_err = max(_max_err(getattr(lg.sim3, f).cpu(), getattr(lc.sim3, f))
                   for f in ("s", "R", "t"))
    d_inl = abs(int(lg.sim3.n_inliers) - int(lc.sim3.n_inliers))
    sim3_same = (bool(lg.ok) == bool(lc.ok) and int(cg) == int(cc)
                 and int(lg.n_matches) == int(lc.n_matches))
    mg, mc = map_to_numpy(g["apply"][0]), map_to_numpy(c["apply"][0])
    apply_err = max(_max_err(mg[f], mc[f]) for f in ("kf_R", "kf_t",
                                                      "lm_pos"))
    med_err = max(_rel_err(g["apply"][i], c["apply"][i]) for i in (3, 4))
    sg, sc = map_to_numpy(g["slice"][0]), map_to_numpy(c["slice"][0])
    slice_err = max(_max_err(sg[f], sc[f]) for f in ("kf_R", "kf_t",
                                                      "lm_pos"))

    # Repeats on the card from the same inputs: bit for bit.
    s = sides["cuda"]
    m_in, lp_dev, sl_in = g["inputs"]
    ap2 = s._loop_apply(m_in, kf_a, cand_a, lp_dev)
    apply_bits = _maps_equal(ap2[0], g["apply"][0]) and all(
        x.equal(y) for x, y in zip(ap2[1:], g["apply"][1:]))
    sl2 = s._global_slice(sl_in, lam, prune)
    slice_bits = _maps_equal(sl2[0], g["slice"][0]) and all(
        x.equal(y) for x, y in zip(sl2[1:], g["slice"][1:]))
    res = dict(
        phase="loop_parity", kf=int(kf), cands=cands.tolist(),
        tolerances=dict(sim3=1e-4, inliers=2, apply=1e-3,
                        medians_rel=1e-3, global_slice=1e-3),
        sim3=dict(ok=bool(lc.ok), cand=int(cc), n_matches=int(lc.n_matches),
                  n_inliers_cpu=int(lc.sim3.n_inliers),
                  n_inliers_diff=d_inl, s=float(lc.sim3.s), srt_err=sim3_err,
                  verdict_candidate_matches_equal=sim3_same),
        apply=dict(kf=int(kf_a), cand=int(cand_a), err=apply_err,
                   median_before=float(c["apply"][3]),
                   median_after=float(c["apply"][4]),
                   medians_rel_err=med_err,
                   moved=_max_err(mc["kf_t"], m_apply["kf_t"]),
                   repeat_bit_equal=apply_bits),
        global_slice=dict(lam=float(lam), prune=bool(prune), err=slice_err,
                          repeat_bit_equal=slice_bits),
        card_ms_per_call=card_ms, cpu_seconds=c["seconds"])
    emit(res)
    if not (sim3_same and d_inl <= 2 and sim3_err <= 1e-4):
        fail(f"_loop_sim3 card vs CPU: verdict/candidate/matches equal "
             f"{sim3_same}, inliers differ by {d_inl}, s/R/t err {sim3_err}")
    if not (apply_err <= 1e-3 and med_err <= 1e-3):
        fail(f"_loop_apply card vs CPU: err {apply_err}, medians rel err "
             f"{med_err}")
    if not slice_err <= 1e-3:
        fail(f"_global_slice card vs CPU: err {slice_err}")
    if not (apply_bits and slice_bits):
        fail(f"repeats on the card not bit-equal: _loop_apply {apply_bits}, "
             f"_global_slice {slice_bits}")
    return res


def map_io_phase(torch, System, cfg, system, frames, ts):
    """Phase 9: the main run's final map saved and loaded into a fresh
    System on the card (every field equal, same dtype), which must then
    relocalize on mapped frames without initializing."""
    from send_slam_tpu_torch.models.map_state import MapState
    from send_slam_tpu_torch.models.system import TRACKING_OK
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        t0 = time.perf_counter()
        system.save_map(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        fresh = System(cfg, device="cuda")
        t0 = time.perf_counter()
        fresh.load_map(path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    differ = [f.name for f in dataclasses.fields(MapState)
              if not (getattr(fresh.map, f.name).dtype
                      == getattr(system.map, f.name).dtype
                      and getattr(fresh.map, f.name).device.type == "cuda"
                      and getattr(fresh.map, f.name).equal(
                          getattr(system.map, f.name)))]
    n_kf = int(fresh.map.n_kf)
    states = []
    first = len(frames) // 3
    for i in range(MAP_IO_RELOC_FRAMES):
        out = fresh.track_monocular(frames[first + i],
                                    100.0 + float(ts[first + i]))
        states.append(out.tracking_state)
        if out.tracking_state == TRACKING_OK:
            break
    res = dict(phase="map_io", file_bytes=size, save_ms=save_ms,
               load_ms=load_ms, fields_differing=differ, keyframes=n_kf,
               landmarks=int(fresh.map.n_landmarks()), states=states,
               init_attempts=fresh.init_attempts,
               reloc=fresh.last_reloc)
    emit(res)
    if differ:
        fail(f"map I/O round trip differs in {differ}")
    if TRACKING_OK not in states or fresh.init_attempts:
        fail(f"the loaded map did not relocalize within "
             f"{MAP_IO_RELOC_FRAMES} mapped frames without initializing "
             f"(states {states}, init attempts {fresh.init_attempts})")
    return res


def _arc_poses(n):
    """tests/test_covisibility.py's long-session arc: 3.5 m forward with
    a 0.3 rad yaw, over ``n`` frames."""
    poses = []
    for k in range(n):
        a = k / (n - 1)
        c = np.array([3.5 * a, 0.1 * np.sin(2 * np.pi * a), 0.5 * a])
        cy, sy = np.cos(-0.3 * a), np.sin(-0.3 * a)
        R = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]]).T
        poses.append((R, -R @ c))
    return poses


def _session_ates(system, run, poses, ts):
    """The streamed ATE and the end keyframe ATE of a session against
    the poses of its rendered frames."""
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    seen = [k for k, p in enumerate(poses) if p is not None]
    gt_ts = np.asarray(ts)[seen]
    gt = np.asarray([-poses[k][0].T @ poses[k][1] for k in seen])
    kts, kpos, _ = system.keyframe_poses()
    return dict(
        streamed_ate_m=(ate_rmse(run["est_ts"], run["est_pos"], gt_ts, gt)
                        if len(run["est_ts"]) >= 3 else None),
        kf_ate_end_m=(ate_rmse(kts, kpos, gt_ts, gt) if len(kts) >= 3
                      else None))


def _map_bytes(m):
    return sum(getattr(m, f.name).nbytes for f in dataclasses.fields(m))


def long_session(torch, System, cfg, fast_cuda):
    """Phase 12: compaction on the card. The long-session arc of
    tests/test_covisibility.py at 640x480 with the flagship ORB and
    landmark table and that test's 10-keyframe table, BA window 4 and
    tracking overrides; the inputs of the first forced cull and of the
    compaction after it are kept for long_parity."""
    from send_slam_tpu_torch.config import MapConfig
    from send_slam_tpu_torch.models.system import TRACKING_OK
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    cfg = cfg.replace(
        map=MapConfig(max_keyframes=LONG_MK, max_landmarks=16384,
                      ba_window=4),
        tracking=dataclasses.replace(
            cfg.tracking, init_min_matches=50, kf_max_interval=6,
            pipeline_depth=1, pipeline_stretch=1))
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0)
    poses = _arc_poses(LONG_FRAMES)
    frames = Rendered(world, poses)
    ts = [k / 30.0 for k in range(LONG_FRAMES)]
    system = System(cfg, device="cuda")
    ms = time_calls(torch, system, ("_compact_step", "_forced_cull_step"))
    keep = dict(cull=None, compact=None)
    calls = dict(compact=0, cull=0)
    for name in ("_compact_step", "_forced_cull_step"):
        def call(m, _fn=getattr(system, name), _n=name):
            if _n == "_forced_cull_step":
                calls["cull"] += 1
                if keep["cull"] is None:
                    keep["cull"] = m
            else:
                calls["compact"] += 1
                if keep["cull"] is not None and keep["compact"] is None:
                    keep["compact"] = m
            return _fn(m)
        setattr(system, name, call)
    fast_cuda.launches = 0
    system.frames_extracted = 0
    run = drive(torch, system, frames, ts)
    launches, n_extracted = fast_cuda.launches, system.frames_extracted
    states = run["states"]
    n_ok = sum(st == TRACKING_OK for st in states)
    tail_ok = sum(st == TRACKING_OK for st in states[-10:])
    res = dict(
        phase="long_session",
        scene=f"SyntheticWorld(n_points=900, 640x480, fx=fy=520), the arc "
              f"of tests/test_covisibility.py, {LONG_FRAMES} frames",
        config=f"flagship ORB, MapConfig(max_keyframes={LONG_MK}, "
               f"max_landmarks=16384, ba_window=4), init_min_matches=50, "
               f"kf_max_interval=6, pipeline_depth=1, pipeline_stretch=1",
        frames=len(states), ok_frames=n_ok, ok_last_10=tail_ok,
        keyframes_inserted=int(system._n_kf_host),
        slots_used=system._slots_used,
        compactions=calls["compact"] - calls["cull"],
        forced_culls=calls["cull"], compact_step_calls=calls["compact"],
        tracked=len(run["est_ts"]), **_session_ates(system, run, poses, ts),
        ms_per_call=ms, landmarks=run["landmarks"],
        frames_through_make_frame=n_extracted, fast_launches=launches,
        median_ms_per_tracked_frame=(statistics.median(run["t_ok"][1:])
                                     if len(run["t_ok"]) > 1 else None),
        seconds=run["seconds"])
    emit(res)
    if launches != n_extracted or launches == 0:
        fail(f"long session: {launches} FAST launches for {n_extracted} "
             "frames (expected one per make_frame)")
    if not (system._n_kf_host > LONG_MK and res["compactions"] >= 1):
        fail(f"long session: {system._n_kf_host} keyframes inserted into a "
             f"table of {LONG_MK}, {res['compactions']} compactions")
    if not (n_ok > LONG_MIN_OK and tail_ok >= 8):
        fail(f"long session: {n_ok} of {len(states)} frames OK, {tail_ok} "
             "of the last 10")
    if keep["compact"] is None:
        fail("long session: no forced cull, so no culled map to compare")
    return res, keep


def _atlas_world():
    """tests/test_atlas.py's world: regions A and B of 600 points each,
    rendered at 640x480 with fx = fy = 520."""
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    world = SyntheticWorld(n_points=1200, width=640, height=480, fx=520.0,
                           fy=520.0)
    rng = np.random.default_rng(5)
    world.points = np.concatenate([
        rng.uniform([-6, -4.5, 3], [2, 4.5, 10], (600, 3)),
        rng.uniform([8, -4.5, 3], [16, 4.5, 10], (600, 3))])
    return world


def atlas_poses():
    """tests/test_atlas.py's 210 frames: 45 of region A, 15 black while
    the camera jumps, 30 of region B, 110 back towards A, a hold of 10."""
    def at(x):
        return np.eye(3), -np.array([x, 0.0, 0.0])
    return ([at(1.2 * k / 44) for k in range(45)] + [None] * 15
            + [at(10.0 - 0.8 * k / 29) for k in range(30)]
            + [at(9.2 - 8.2 * k / 109) for k in range(110)]
            + [at(1.0)] * 10)


ATLAS_PROGRAMS = ("_atlas_cand", "_atlas_sim3", "_atlas_weld",
                  "_global_slice")
ATLAS_FAILED_FROM = 150         # the failed verification kept: first from here


def atlas_path(torch, System, cfg, fast_cuda):
    """Phase 13: freeze and weld on the card, with the atlas programs
    timed. Kept for long_parity: the inputs of the first weld probe, of
    the verified cross-map Sim(3), of the weld and of the first global
    slice after it, and the final map; and for
    scripts/atlas_verdicts.py the first failed verification at or past
    frame ATLAS_FAILED_FROM."""
    from send_slam_tpu_torch.models.system import TRACKING_OK
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, pipeline_stretch=1, init_min_matches=40,
        kf_max_interval=5, atlas_reloc_patience=8, atlas_min_kf=5))
    poses = atlas_poses()
    frames = Rendered(_atlas_world(), poses)
    ts = [k / 30.0 for k in range(len(frames))]
    system = System(cfg, device="cuda")
    ms = time_calls(torch, system, ATLAS_PROGRAMS)
    frame_now = [0]
    ev = dict(freeze=[], weld=[], sim3=[], cand=None, slice=None)
    freeze = system._freeze_to_atlas

    def on_freeze():
        freeze()
        ev["freeze"].append(dict(frame=frame_now[0],
                                 frozen_map_bytes=_map_bytes(
                                     system.atlas[-1]),
                                 keyframes=int(system.atlas[-1].n_kf)))

    system._freeze_to_atlas = on_freeze
    cand, sim3, weld = (system._atlas_cand, system._atlas_sim3,
                        system._atlas_weld)

    def on_cand(fz, sig):
        if ev["cand"] is None:
            ev["cand"] = (fz, sig)
        return cand(fz, sig)

    def on_sim3(*a):
        out = sim3(*a)
        ev["sim3"].append(dict(args=a, out=out, frame=frame_now[0]))
        return out

    def on_weld(*a):
        out = weld(*a)
        ev["weld"].append(dict(args=a, frame=frame_now[0],
                               kf_imported=int(out[1]),
                               lm_imported=int(out[2])))
        return out

    system._atlas_cand, system._atlas_sim3, system._atlas_weld = \
        on_cand, on_sim3, on_weld
    glob = system._global_slice

    def on_slice(*a):
        if ev["weld"] and ev["slice"] is None:
            ev["slice"] = a
        return glob(*a)

    system._global_slice = on_slice

    def after_frame(k, s):
        frame_now[0] = k + 1

    fast_cuda.launches = 0
    system.frames_extracted = 0
    run = drive(torch, system, frames, ts, after_frame=after_frame)
    launches, n_extracted = fast_cuda.launches, system.frames_extracted
    states = run["states"]
    tail_ok = sum(st == TRACKING_OK for st in states[-10:])
    res = dict(
        phase="atlas_path",
        scene="tests/test_atlas.py's two-region world (1200 points) at "
              "640x480, fx=fy=520: 45 frames of A, 15 black, 30 of B, 110 "
              "back towards A, 10 held",
        config="flagship ORB and map, pipeline_stretch=1, "
               "init_min_matches=40, kf_max_interval=5, "
               "atlas_reloc_patience=8, atlas_min_kf=5",
        frames=len(states),
        ok_frames=sum(st == TRACKING_OK for st in states),
        ok_last_10=tail_ok, freezes=ev["freeze"],
        weld_attempts=[dict(frame=e["frame"], ok=bool(e["out"].ok),
                            n_matches=int(e["out"].n_matches),
                            n_inliers=int(e["out"].sim3.n_inliers),
                            s=float(e["out"].sim3.s)) for e in ev["sim3"]],
        welds=[{k: v for k, v in e.items() if k != "args"}
               for e in ev["weld"]],
        welds_done=system.welds_done, atlas_left=len(system.atlas),
        tracked=len(run["est_ts"]), **_session_ates(system, run, poses, ts),
        keyframes=int(system.map.n_kf), landmarks=run["landmarks"],
        polish_slices=run["polish_slices"], ms_per_call=ms,
        frames_through_make_frame=n_extracted, fast_launches=launches,
        median_ms_per_tracked_frame=(statistics.median(run["t_ok"][1:])
                                     if len(run["t_ok"]) > 1 else None),
        seconds=run["seconds"])
    emit(res)
    if launches != n_extracted or launches == 0:
        fail(f"atlas path: {launches} FAST launches for {n_extracted} "
             "frames (expected one per make_frame)")
    if not ev["freeze"]:
        fail("atlas path: no map froze")
    if not (system.welds_done >= 1 and not system.atlas):
        fail(f"atlas path: {system.welds_done} welds, {len(system.atlas)} "
             "maps left in the atlas")
    if tail_ok < 8:
        fail(f"atlas path: {tail_ok} of the last 10 frames OK")
    verified = [e for e in ev["sim3"] if bool(e["out"].ok)]
    failed = [e for e in ev["sim3"] if not bool(e["out"].ok)
              and e["frame"] >= ATLAS_FAILED_FROM]
    if ev["slice"] is None:
        fail("atlas path: no global slice ran after the weld")
    return res, dict(cand=ev["cand"], sim3=verified[0]["args"],
                     weld=ev["weld"][0]["args"], slice=ev["slice"],
                     final=system.map,
                     sim3_failed=failed[0] if failed else None)


def _pack(x):
    """MapStates and tensors in ``x`` moved to the CPU, MapStates as
    field dicts (for torch.save)."""
    if dataclasses.is_dataclass(x):
        return {"__map__": {f.name: getattr(x, f.name).cpu()
                            for f in dataclasses.fields(x)}}
    if isinstance(x, (tuple, list)):
        return tuple(_pack(v) for v in x)
    if isinstance(x, dict):
        return {k: _pack(v) for k, v in x.items()}
    return x.cpu() if hasattr(x, "cpu") else x


def _unpack(x, dev):
    """The inverse of _pack, onto ``dev``."""
    from send_slam_tpu_torch.models.map_state import MapState
    if isinstance(x, dict) and "__map__" in x:
        return MapState(**{k: v.to(dev) for k, v in x["__map__"].items()})
    if isinstance(x, tuple):
        return tuple(_unpack(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _unpack(v, dev) for k, v in x.items()}
    return x.to(dev) if hasattr(x, "to") else x


def flagship_config():
    """The flagship configuration with bench.py's camera."""
    from send_slam_tpu_torch.config import CameraConfig, EngineConfig
    return EngineConfig(camera=CameraConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0))


def sessions_main(outdir: str) -> int:
    """Phases 12 and 13 in a process of their own, which main() starts
    after the server phases so that they run beside phases 7-11: their JSON
    lines go to standard output, what long_parity needs to
    ``outdir/kept.pt``."""
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from send_slam_tpu_torch.models.system import System
    from send_slam_tpu_torch.ops import fast_cuda
    fast_cuda.load()
    cfg = flagship_config()
    _, kept_long = long_session(torch, System, cfg, fast_cuda)
    _, kept_atlas = atlas_path(torch, System, cfg, fast_cuda)
    scale_path(torch, System, fast_cuda)
    kept_atlas.pop("sim3_failed")
    torch.save(_pack(dict(kept_long, **kept_atlas)),
               os.path.join(outdir, "kept.pt"))
    return 0


def start_child(flag: str, outdir: str):
    """``chip_smoke.py flag outdir`` in a process of its own, its output
    to outdir/<name>.out and .err (name: the flag without dashes)."""
    name = flag.strip("-")
    with open(os.path.join(outdir, name + ".out"), "w") as out, \
            open(os.path.join(outdir, name + ".err"), "w") as err:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, outdir],
            stdout=out, stderr=err, process_group=0)
    _CHILDREN.append(child)
    return child


def join_child(child, outdir: str, name: str, what: str):
    """Wait for a process of start_child, re-emit its lines, fail on its
    exit code, and return its JSON lines by phase."""
    t0 = time.perf_counter()
    rc = child.wait()
    print(f"chip_smoke: waited {time.perf_counter() - t0:.1f} s for {what}",
          file=sys.stderr, flush=True)
    with open(os.path.join(outdir, name + ".out")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for ln in lines:
        print(ln, flush=True)
    if rc != 0:
        with open(os.path.join(outdir, name + ".err")) as f:
            err = f.read()[-3000:]
        fail(f"{what} exited with {rc}:\n{err}")
    phases = {}
    for ln in lines:
        if ln.startswith("{"):
            obj = json.loads(ln)
            phases[obj.get("phase")] = obj
    return phases


def join_sessions(torch, child, outdir):
    """Wait for the sessions process, re-emit its lines, and return
    (long_session's result, atlas_path's result, the kept inputs on the
    card)."""
    phases = join_child(child, outdir, "sessions",
                        "the long and atlas sessions")
    kept = _unpack(torch.load(os.path.join(outdir, "kept.pt"),
                              weights_only=True), "cuda")
    return phases["long_session"], phases["atlas_path"], \
        phases["scale_path"], kept


def _fields_close(a, b, rel):
    """Integer and boolean fields of two maps equal, float fields within
    ``rel`` of the field's largest magnitude. Returns (equal, worst)."""
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    return _np_fields_close(map_to_numpy(a), map_to_numpy(b), rel)


def _np_fields_close(a, b, rel):
    """_fields_close on two dicts of numpy arrays."""
    same, worst = True, 0.0
    for f in a:
        if a[f].dtype != b[f].dtype or a[f].shape != b[f].shape:
            return False, float("inf")
        if a[f].dtype.kind == "f":
            e = _max_err(a[f], b[f]) / max(float(np.abs(b[f]).max()), 1e-9)
            worst = max(worst, e)
            same &= e <= rel
        else:
            same &= bool(np.array_equal(a[f], b[f]))
    return same, worst


def long_parity(torch, System, kept, cfg):
    """Phase 14: the capacity and atlas programs on the card against the
    CPU, from the maps of long_session and atlas_path (``kept``: the
    inputs of the first forced cull, of the compaction after it, of the
    first weld probe, of the verified cross-map Sim(3), of the weld, and
    atlas_path's final map), and their repeats on the card. The forced
    cull and the compaction run on both tables: long_session's 10 slots,
    and atlas_path's final map at the flagship 256, force-culled and the
    card's culled map compacted. One global slice after the weld is
    timed on the card alone (and repeated bit for bit)."""
    from send_slam_tpu_torch.models.loop_closing import N_HYP
    from send_slam_tpu_torch.models.map_state import MapState
    from send_slam_tpu_torch.models.sim3_solver import gumbel_noise

    def to(m, dev):
        return MapState(**{f.name: getattr(m, f.name).to(dev)
                           for f in dataclasses.fields(MapState)})

    sides = dict(cuda=System(cfg, device="cuda"),
                 cpu=System(cfg, device="cpu"))
    card_ms = time_calls(torch, sides["cuda"], (
        "_compact_step", "_forced_cull_step") + ATLAS_PROGRAMS[:3])
    flag = System(cfg, device="cuda")      # the 256-slot calls, timed apart
    flag_ms = time_calls(torch, flag, ("_compact_step", "_forced_cull_step",
                                       "_global_slice"))
    final = kept["final"]
    fz_c, sig = kept["cand"]
    act_s, fz_s, ka, kf, _ = kept["sim3"]
    act_w, fz_w, s, R, t = kept["weld"]
    noise = gumbel_noise(torch.Generator().manual_seed(8),
                         (N_HYP, act_s.n_keypoints), "cpu")
    out = {}
    for name, sy in sides.items():
        dev = sy.device
        t0 = time.perf_counter()
        out[name] = dict(
            compact=sy._compact_step(to(kept["compact"], dev)),
            cull=sy._forced_cull_step(to(kept["cull"], dev)),
            cand=sy._atlas_cand(to(fz_c, dev), sig.to(dev)),
            sim3=sy._atlas_sim3(to(act_s, dev), to(fz_s, dev), ka, kf.to(dev),
                                noise.to(dev)),
            weld=sy._atlas_weld(to(act_w, dev), to(fz_w, dev), s.to(dev),
                                R.to(dev), t.to(dev)),
            seconds=time.perf_counter() - t0)
    g, c = out["cuda"], out["cpu"]
    checks = {}
    checks["cand"] = (int(g["cand"][0]) == int(c["cand"][0])
                      and _rel_err(g["cand"][1], c["cand"][1]) <= 1e-6)
    sg, sc = g["sim3"], c["sim3"]
    srt_err = max(_max_err(getattr(sg.sim3, f).cpu(), getattr(sc.sim3, f))
                  for f in ("s", "R", "t"))
    checks["sim3"] = (bool(sg.ok) == bool(sc.ok)
                      and int(sg.n_matches) == int(sc.n_matches)
                      and sg.sim3.inlier.cpu().equal(sc.sim3.inlier)
                      and srt_err <= 1e-5)
    weld_same, weld_rel = _fields_close(g["weld"][0], c["weld"][0], 1e-6)
    checks["weld"] = weld_same and all(
        int(x) == int(y) for x, y in zip(g["weld"][1:], c["weld"][1:]))

    # The flagship table: the final map force-culled on each side, then
    # the card's culled map compacted on each side.
    g["cull_256"] = flag._forced_cull_step(final)
    c["cull_256"] = sides["cpu"]._forced_cull_step(to(final, "cpu"))
    g["compact_256"] = flag._compact_step(g["cull_256"][0])
    c["compact_256"] = sides["cpu"]._compact_step(to(g["cull_256"][0], "cpu"))
    for prog in ("compact", "cull", "cull_256", "compact_256"):
        checks[prog] = (_fields_close(g[prog][0], c[prog][0], 0.0)[0]
                        and g[prog][1].cpu().equal(c[prog][1]))
    g["slice"] = flag._global_slice(*kept["slice"])

    # Repeats on the card from the same inputs: bit for bit.
    sy = sides["cuda"]
    rep = dict(
        compact=sy._compact_step(to(kept["compact"], "cuda")),
        cull=sy._forced_cull_step(to(kept["cull"], "cuda")),
        cand=sy._atlas_cand(fz_c, sig),
        sim3=sy._atlas_sim3(act_s, fz_s, ka, kf, noise.cuda()),
        weld=sy._atlas_weld(act_w, fz_w, s, R, t),
        cull_256=flag._forced_cull_step(final),
        compact_256=flag._compact_step(g["cull_256"][0]),
        slice=flag._global_slice(*kept["slice"]))
    bits = {}
    for prog in ("compact", "cull", "weld", "cull_256", "compact_256",
                 "slice"):
        bits[prog] = _maps_equal(rep[prog][0], g[prog][0]) and all(
            x.equal(y) for x, y in zip(rep[prog][1:], g[prog][1:]))
    bits["cand"] = all(x.equal(y) for x, y in zip(rep["cand"], g["cand"]))
    bits["sim3"] = (rep["sim3"].ok.equal(sg.ok)
                    and rep["sim3"].n_matches.equal(sg.n_matches)
                    and all(x.equal(y) for x, y in zip(rep["sim3"].sim3,
                                                       sg.sim3)))
    res = dict(
        phase="long_parity",
        tolerances=dict(integers_booleans="exact", compact_cull="every "
                        "field equal", sim3_srt=1e-5,
                        weld_floats_rel=1e-6),
        checks=checks, repeat_bit_equal=bits,
        compact_n_valid=int(c["compact"][1]), culled=int(c["cull"][1]),
        table_256=dict(slots_in=int(final.n_kf),
                       valid_in=int(final.kf_valid.sum()),
                       culled=int(c["cull_256"][1]),
                       compact_n_valid=int(c["compact_256"][1])),
        cand=[int(c["cand"][0]), float(c["cand"][1])],
        sim3=dict(ok=bool(sc.ok), n_matches=int(sc.n_matches),
                  n_inliers=int(sc.sim3.n_inliers), s=float(sc.sim3.s),
                  srt_err=srt_err),
        weld=dict(kf_imported=int(c["weld"][1]),
                  lm_imported=int(c["weld"][2]), float_rel_err=weld_rel),
        card_ms_per_call=card_ms, card_ms_per_call_256=flag_ms,
        cpu_seconds=c["seconds"])
    emit(res)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"card vs CPU differ beyond tolerance in {bad}")
    bad = [k for k, v in bits.items() if not v]
    if bad:
        fail(f"repeats on the card not bit-equal: {bad}")
    if res["table_256"]["culled"] != 1:
        fail("the forced cull of the 256-slot map culled "
             f"{res['table_256']['culled']} keyframes, not 1")
    return res


# ---------------------------------------------------------------------------
# Camera lanes (phases 15-17), in a process of their own

CARD = "cuda"       # where the lanes run (phase 16 holds it against "cpu")


def lanes_scene(shift=LANES_SHIFT, n_frames=N_FRAMES, speed=LANES_SPEED):
    """The bench world (seed 11) and the bench arc's path
    (utils/synth.py trajectory) at ``speed`` times its pace, the arc
    parameter running from 0 to ``speed`` over the ``n_frames`` frames,
    for lane 0; lane 1 runs the same path shifted ``shift`` m along +x.
    Returns (world, ts, poses[lane][k] = (R, t) camera-from-world,
    centres (2, n, 3))."""
    from scipy.spatial.transform import Rotation
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    poses = [[], []]
    for k in range(n_frames):
        a = speed * k / (n_frames - 1)
        c = np.array([1.6 * a, 0.15 * np.sin(2 * np.pi * a), 0.3 * a])
        R = Rotation.from_euler("y", -0.12 * a).as_matrix().T
        for lane, off in enumerate((0.0, shift)):
            poses[lane].append((R, -R @ (c + np.array([off, 0.0, 0.0]))))
    centres = np.asarray([[-R.T @ t for R, t in lane] for lane in poses])
    ts = np.arange(n_frames, dtype=np.float32) / np.float32(30.0)
    return world, ts, poses, centres


def ring_scene():
    """tests/test_parallel.py's merge-consistency scene and configuration:
    8 lanes at 160x120 (256 features, 3 levels, an 8-slot table of 1024
    landmarks), each lane at its own offset, panning and rising."""
    from send_slam_tpu_torch.config import (
        CameraConfig, EngineConfig, MapConfig, OrbConfig, TrackingConfig,
    )
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    world = SyntheticWorld(n_points=700, width=160, height=120, fx=130.0,
                           fy=130.0)
    cfg = EngineConfig(
        orb=OrbConfig(n_features=256, n_levels=3),
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0),
        map=MapConfig(max_keyframes=8, max_landmarks=1024, ba_window=4),
        tracking=TrackingConfig(init_min_matches=30, kf_max_interval=3))
    centres = np.asarray([[[0.35 * c - 1.2 + 0.12 * s, 0.05 * np.sin(0.7 * s),
                            0.05 * s] for s in range(RING_STEPS)]
                          for c in range(RING_LANES)])
    return world, cfg, centres


def lane_ates(rows, ts, centres):
    """Per lane: the Sim(3)-aligned ATE of its streamed positions on the
    steps it was TRACKING, and that alignment (s, R, t), the lane's
    gauge; (inf, None) with fewer than 3 such steps."""
    from send_slam_tpu_torch.io.evaluate import ate_rmse, umeyama_alignment
    from send_slam_tpu_torch.parallel.multicam import MODE_TRACKING
    out = []
    for c in range(rows.shape[1]):
        ok = np.flatnonzero(rows[:, c, 0] == MODE_TRACKING)
        if len(ok) < 3:
            out.append((float("inf"), None))
            continue
        est = rows[ok, c, 4:7].astype(np.float64)
        n = len(rows)
        out.append((ate_rmse(ts[ok], est, ts[:n], centres[c][:n]),
                    umeyama_alignment(est, centres[c][ok], with_scale=True)))
    return out


def import_structure(pre_valid, post_valid, post_pos, gauge,
                     world_points):
    """(landmarks a merge imported into a lane, given the lane's
    landmark validity before and after it and its positions after, as
    numpy; the median distance of those, mapped through the lane's
    gauge, to the nearest true world point, None without a gauge or
    imports)."""
    imported = post_valid & ~pre_valid
    if gauge is None or not imported.any():
        return int(imported.sum()), None
    s, R, t = gauge
    X = post_pos[imported].astype(np.float64)
    W = (s * (R @ X.T)).T + t
    d = np.sqrt(((W[:, None, :] - world_points[None]) ** 2).sum(-1)).min(1)
    return int(imported.sum()), float(np.median(d))


def run_lanes(torch, step, state, images, steps, after=None):
    """Drive ``step`` over ``steps`` (``images(k)`` -> (imgs, tss)), each
    step ending in a device sync. ``after(k, before, summary)`` sees the
    state before each step and the step's summary. Returns (state, the
    summaries (n, lanes, 10) on the host, ms per step)."""
    rows, ms = [], []
    for k in steps:
        imgs, tss = images(k)
        t0 = time.perf_counter()
        before = state
        state, summary = step(state, imgs, tss)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(summary.cpu().numpy())
        if after is not None:
            after(k, before, rows[-1])
    return state, np.asarray(rows), ms


@contextlib.contextmanager
def launch_record(fast_cuda):
    """Record each FAST launch made inside the block as (levels,
    threshold, outputs); the tensors are held, not copied (nothing
    writes into a launch's inputs or outputs). The launch counter is the
    wrapper's own. Every launch is a batched one (a System's make_frame
    is a batch of one)."""
    real = fast_cuda.fast_score_levels_cuda
    launches = []

    def spy(levels, threshold, with_nms=False):
        levels = list(levels)
        out = real(levels, threshold, with_nms)
        if not with_nms or levels[0].dim() != 3:
            fail("a recorded launch was not a batched launch with NMS")
        launches.append((levels, threshold, out))
        return out

    fast_cuda.fast_score_levels_cuda = spy
    try:
        yield launches
    finally:
        fast_cuda.fast_score_levels_cuda = real


def launch_shapes(launches):
    """The distinct (lanes, levels) of recorded launches."""
    return sorted({(levels[0].shape[0], len(levels))
                   for levels, _, _ in launches})


def hold_launches(fast_ops, launches, what):
    """Every recorded launch against the plain version, bit for bit
    (hold_launch), then dropped. Returns (launches held, the largest
    difference)."""
    err = 0.0
    for i, (levels, th, out) in enumerate(launches):
        err = max(err, hold_launch(fast_ops, levels, th, out,
                                   f"{what}'s launch {i}"))
    n = len(launches)
    launches.clear()
    return n, err


def timed_merge(torch, merge, maps, noises):
    """One ring merge on the card: (maps', ok, n_imported, ms, peak
    device bytes above what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    merged, ok, n_imp = merge(maps, noises)
    torch.cuda.synchronize()
    return (merged, ok, n_imp, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() - base)


def lanes_path(torch, fast_cuda):
    """Phase 15: two flagship lanes on the bench world with loop closing,
    one ring merge after LANES_MERGE_AFTER steps, LANES_AFTER more steps
    on the merged maps; the FAST launches counted around the run, and
    each held against the plain version after it."""
    from send_slam_tpu_torch.ops import fast as fast_ops
    from send_slam_tpu_torch.parallel import (
        init_multicam, make_mesh, multicam_slam_step,
    )
    from send_slam_tpu_torch.parallel.map_merge import (
        merge_noise, multicam_merge_step,
    )
    from send_slam_tpu_torch.parallel.multicam import MODE_TRACKING
    cfg = flagship_config()
    world, ts, poses, centres = lanes_scene()
    mesh = make_mesh(1)

    def images(k):
        imgs = np.stack([np.round(world.render(*poses[c][k])).astype(np.uint8)
                         for c in range(2)])
        return imgs, np.full(2, ts[k], np.float32)

    step = multicam_slam_step(cfg, mesh, loop_closing=True)
    carried, last = {}, {}

    def carry(k, before, row):
        # lanes_parity's carried states, each the state before a step:
        # the first in which a lane commits its init ("commit"), the
        # first in which a lane tracking past its bootstrap inserts a
        # keyframe ("keyframe"), and the first that both lanes track
        # without a keyframe after both lanes' first keyframe past the
        # bootstrap ("tracked").
        prev = last.get("row")
        last["row"] = row
        if prev is None:
            return
        trk, was = row[:, 0] == MODE_TRACKING, prev[:, 0] == MODE_TRACKING
        new_kf = row[:, 8] > prev[:, 8]
        if (trk & ~was).any():
            carried.setdefault("commit", (k, before))
        if (trk & was & new_kf & (prev[:, 8] >= 2)).any():
            carried.setdefault("keyframe", (k, before))
        if trk.all() and (prev[:, 8] >= 3).all() and not new_kf.any():
            carried.setdefault("tracked", (k, before))

    t_phase = time.perf_counter()
    fast_cuda.launches = 0
    with launch_record(fast_cuda) as recorded:
        state = init_multicam(cfg, 2, device=CARD, seed=0)
        state, rows_a, ms_a = run_lanes(torch, step, state, images,
                                        range(LANES_MERGE_AFTER),
                                        after=carry)
        pre = state.maps
        noises = merge_noise(2, cfg.map.max_landmarks, seed=15)
        merged, ok, n_imp, merge_ms, merge_peak = timed_merge(
            torch, multicam_merge_step(cfg, mesh), pre, noises)
        state, rows_b, ms_b = run_lanes(
            torch, step, state._replace(maps=merged), images,
            range(LANES_MERGE_AFTER, LANES_MERGE_AFTER + LANES_AFTER))
    launches = fast_cuda.launches
    shapes = launch_shapes(recorded)
    held, held_err = hold_launches(fast_ops, recorded, "lanes_path")
    rows = np.concatenate([rows_a, rows_b])
    n_steps = len(rows)
    ates = lane_ates(rows, ts, centres)
    commits, ok_share, imports = [], [], []
    for c in range(2):
        tracked = rows[:, c, 0] == MODE_TRACKING
        first = int(np.argmax(tracked)) if tracked.any() else None
        commits.append(first)
        ok_share.append(float(tracked[first:].mean()) if first is not None
                        else 0.0)
        imports.append(import_structure(
            pre.lm_valid[c].cpu().numpy(), merged.lm_valid[c].cpu().numpy(),
            merged.lm_pos[c].cpu().numpy(), ates[c][1], world.points))
    ms = ms_a + ms_b
    res = dict(
        phase="lanes_path", lanes=2,
        config="flagship EngineConfig, loop closing on; lane 0 the bench "
               f"arc's path at {LANES_SPEED}x its pace, lane 1 the same "
               f"shifted {LANES_SHIFT} m along +x",
        steps=n_steps, merge_after=LANES_MERGE_AFTER,
        commit_steps=commits, tracking_share_after_commit=ok_share,
        final_modes=rows[-1, :, 0].astype(int).tolist(),
        modes_by_step=["".join(str(int(x)) for x in rows[:, c, 0])
                       for c in range(2)],
        kf_total=rows[-1, :, 8].astype(int).tolist(),
        n_kf=rows[-1, :, 2].astype(int).tolist(),
        landmarks=rows[-1, :, 3].astype(int).tolist(),
        loops=rows[-1, :, 9].astype(int).tolist(),
        ate_m=[a for a, _ in ates],
        ate_before_merge_m=[a for a, _ in lane_ates(rows_a, ts, centres)],
        merge=dict(ok=ok.cpu().tolist(), imported=n_imp.cpu().tolist(),
                   import_median_to_structure_m=[m for _, m in imports],
                   ms=merge_ms, peak_device_bytes=merge_peak),
        fast_launches=launches, launch_shapes=shapes,
        launches_held_against_plain=held, held_max_abs_err=held_err,
        median_ms_per_step=statistics.median(ms),
        median_ms_per_lane_step=statistics.median(ms) / 2,
        mean_ms_per_step=statistics.fmean(ms),
        median_ms_per_step_after_merge=statistics.median(ms_b),
        parity_steps={n: k for n, (k, _) in carried.items()},
        seconds=time.perf_counter() - t_phase)
    emit(res)
    for c in range(2):
        if commits[c] is None:
            fail(f"lanes_path: lane {c} never committed an init")
        if ok_share[c] < 0.5:
            fail(f"lanes_path: lane {c} tracked {ok_share[c]:.2f} of the "
                 "steps after its commit (< 0.5)")
        if not np.isfinite(ates[c][0]):
            fail(f"lanes_path: lane {c} has no finite ATE")
    if (rows[-1, :, 0] != MODE_TRACKING).any():
        fail(f"lanes_path: lanes not all TRACKING at the end: "
             f"{res['final_modes']}")
    if not bool(ok.all()) or int(n_imp.min()) < LANES_MIN_IMPORTS:
        fail(f"lanes_path: merge ok {res['merge']['ok']}, imports "
             f"{res['merge']['imported']} (each lane must merge with >= "
             f"{LANES_MIN_IMPORTS} imports)")
    dist = res["merge"]["import_median_to_structure_m"]
    if any(d is None or not d <= LANES_MAX_IMPORT_DIST for d in dist):
        fail(f"lanes_path: the imports lie {dist} m from the true "
             f"structure through each lane's gauge (median; the bar is "
             f"{LANES_MAX_IMPORT_DIST} m)")
    if launches != n_steps or held != n_steps \
            or shapes != [(2, cfg.orb.n_levels)]:
        fail(f"lanes_path: {launches} FAST launches ({held} held against "
             f"the plain version) of (lanes, levels) {shapes} for "
             f"{n_steps} steps (expected one per step over 2 lanes x "
             f"{cfg.orb.n_levels} levels)")
    missing = {"commit", "keyframe", "tracked"} - set(carried)
    if missing:
        fail(f"lanes_path: no {sorted(missing)} step to carry to "
             "lanes_parity")
    return res, dict(cfg=cfg, mesh=mesh, pre=pre, merged=merged,
                     noises=noises, ok=ok, n_imp=n_imp, steps={
                         n: dict(step=k, state=st, inputs=images(k),
                                 row_before=rows[k - 1])
                         for n, (k, st) in carried.items()})


def _lane_state_to(state, dev):
    """A MultiCamState with every tensor on ``dev`` (the generator
    states stay on the CPU)."""
    from send_slam_tpu_torch.models.map_state import MapState
    return state._replace(
        maps=MapState(**{f.name: getattr(state.maps, f.name).to(dev)
                         for f in dataclasses.fields(MapState)}),
        **{f: getattr(state, f).to(dev) for f in state._fields
           if f not in ("maps", "rng")})


def lanes_parity(torch, kept):
    """Phase 16: the lane step and the ring merge, card against CPU, on
    lanes_path's carried states (an init commit, a keyframe insertion
    and a tracked step) and pre-merge maps; and their repeats on the
    card. The lanes' generators travel in the carried state, so both
    sides take the same RANSAC draws; the merges take lanes_path's
    noise."""
    from send_slam_tpu_torch.parallel import make_mesh, multicam_slam_step
    from send_slam_tpu_torch.parallel.map_merge import merge_from_partner
    from send_slam_tpu_torch.parallel.multicam import (
        MODE_TRACKING, lane_map, multicam_state_to_numpy,
    )
    t_phase = time.perf_counter()
    cfg = kept["cfg"]
    steps = dict(cuda=multicam_slam_step(cfg, kept["mesh"],
                                         loop_closing=True),
                 cpu=multicam_slam_step(cfg, make_mesh(1, devices=["cpu"]),
                                        loop_closing=True))
    checks, bits, step_rows = {}, {}, []
    exact_cols = [0, 2, 3, 7, 8, 9]
    for name, carried in kept["steps"].items():
        imgs, tss = carried["inputs"]
        out, secs = {}, {}
        for dev in ("cuda", "cpu", "repeat"):
            t0 = time.perf_counter()
            st, summary = steps["cpu" if dev == "cpu" else CARD](
                _lane_state_to(carried["state"],
                               "cpu" if dev == "cpu" else CARD),
                imgs, tss)
            secs[dev] = time.perf_counter() - t0
            out[dev] = (multicam_state_to_numpy(st), summary.cpu().numpy())
        (g, gs), (c, cs), (r, rs) = out["cuda"], out["cpu"], out["repeat"]
        pose_err = max(_max_err(gs[:, 4:7], cs[:, 4:7]),
                       _max_err(g["R"], c["R"]), _max_err(g["t"], c["t"]))
        ints = [f for f, v in c.items()
                if f != "maps" and v.dtype.kind != "f"]
        map_same, map_rel = _np_fields_close(g["maps"], c["maps"], 1e-6)
        ba_err = {}
        if name != "tracked":
            # The commit's and the keyframe's bundle adjustment: its
            # outputs, and the landmark statistics computed from them, at
            # BA_TOL (absolute); every other field as the tracked step's.
            ba_err = {f: _max_err(g["maps"][f], c["maps"][f])
                      for f in BA_TOL}
            rest = [f for f in c["maps"] if f not in BA_TOL]
            map_same, map_rel = _np_fields_close(
                {f: g["maps"][f] for f in rest},
                {f: c["maps"][f] for f in rest}, 1e-6)
            map_same &= all(ba_err[f] <= BA_TOL[f] for f in BA_TOL)
        checks[name] = dict(
            summary_exact=bool(np.array_equal(gs[:, exact_cols],
                                              cs[:, exact_cols])),
            inliers_pm2=bool(np.abs(gs[:, 1] - cs[:, 1]).max() <= 2),
            poses_1e_4=pose_err <= 1e-4,
            lane_integers=all(np.array_equal(g[f], c[f]) for f in ints),
            maps=map_same)
        bits[name] = bool(np.array_equal(gs, rs)) and all(
            np.array_equal(g[f], r[f]) for f in g if f != "maps") and all(
            np.array_equal(g["maps"][f], r["maps"][f]) for f in g["maps"])
        before = carried["row_before"]
        step_rows.append(dict(
            carried=name, step=carried["step"], pose_err=pose_err,
            map_float_rel_err=map_rel,
            ba_fields_abs_err=ba_err,
            committed=((cs[:, 0] == MODE_TRACKING)
                       & (before[:, 0] != MODE_TRACKING)).tolist(),
            kf_inserted=(cs[:, 8] > before[:, 8]).tolist(),
            loops=cs[:, 9].astype(int).tolist(),
            cpu_step_s=secs["cpu"], card_step_s=secs["cuda"]))

    # The merge, lane by lane as the ring runs it: on the card (equal to
    # lanes_path's merged lane bit for bit) and on the CPU.
    tr = cfg.tracking
    pre, merged = kept["pre"], kept["merged"]
    merge_rows = []
    t_cpu = 0.0
    for k in range(2):
        j = (k + 1) % 2
        res = {}
        for dev in (CARD, "cpu"):
            t0 = time.perf_counter()
            res[dev] = merge_from_partner(
                lane_map(pre, k, dev), pre.lm_pos[j].to(dev),
                pre.lm_desc[j].to(dev), pre.lm_valid[j].to(dev),
                kept["noises"][k], tr, with_sim3=True)
            if dev == "cpu":
                t_cpu += time.perf_counter() - t0
        mg, okg, ng, sg = res[CARD]
        mc, okc, nc, sc = res["cpu"]
        new_g = (mg.lm_valid & ~pre.lm_valid[k]).cpu()
        new_c = mc.lm_valid & ~pre.lm_valid[k].cpu()
        srt = max(_max_err(getattr(sg, f).cpu(), getattr(sc, f))
                  for f in ("s", "R", "t"))
        merge_rows.append(dict(
            lane=k, ok=bool(okc), imported=int(nc), srt_err=srt,
            s=float(sc.s), sim3_inliers=int(sc.n_inliers),
            imported_pos_err=_max_err(mg.lm_pos.cpu()[new_c],
                                      mc.lm_pos[new_c])
            if bool(new_c.equal(new_g)) and int(nc) else 0.0,
            cpu_equal=bool(okg.cpu() == okc) and int(ng) == int(nc)
            and bool(new_g.equal(new_c)) and srt <= 1e-5,
            card_repeat_equal=_maps_equal(mg, lane_map(merged, k))
            and bool(okg == kept["ok"][k]) and bool(ng == kept["n_imp"][k])))
    checks["merge"] = dict(cpu_equal=all(m["cpu_equal"]
                                         for m in merge_rows))
    bits["merge"] = all(m["card_repeat_equal"] for m in merge_rows)
    res = dict(
        phase="lanes_parity",
        tolerances=dict(step_integers="exact", inliers=2, poses=1e-4,
                        map_floats_rel=1e-6, ba_fields_abs=BA_TOL,
                        merge="ok, imports and the import mask exact, "
                        "s/R/t 1e-5"),
        checks=checks, repeat_bit_equal=bits, steps=step_rows,
        merge=merge_rows, cpu_merge_s=t_cpu,
        seconds=time.perf_counter() - t_phase)
    emit(res)
    bad = [f"{k}.{c}" for k, v in checks.items() for c, ok in v.items()
           if not ok]
    if bad:
        fail(f"lanes_parity: card vs CPU differ beyond tolerance in {bad}")
    bad = [k for k, v in bits.items() if not v]
    if bad:
        fail(f"lanes_parity: repeats on the card not bit-equal: {bad}")
    return res


def lanes_ring(torch, fast_cuda):
    """Phase 17: 8 lanes on tests/test_parallel.py's merge scene, then
    the ring merge; the same-seed rerun must be bit-equal. Every FAST
    launch is held against the plain version after its run."""
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    from send_slam_tpu_torch.ops import fast as fast_ops
    from send_slam_tpu_torch.parallel import (
        init_multicam, make_mesh, multicam_slam_step,
    )
    from send_slam_tpu_torch.parallel.map_merge import (
        merge_noise, multicam_merge_step,
    )
    from send_slam_tpu_torch.parallel.multicam import (
        MODE_TRACKING, multicam_state_to_numpy,
    )
    world, cfg, centres = ring_scene()
    ts = np.arange(RING_STEPS, dtype=np.float32) / 30.0
    mesh = make_mesh(1)
    step = multicam_slam_step(cfg, mesh)
    merge = multicam_merge_step(cfg, mesh)

    rendered = [np.stack([world.render(np.eye(3), -centres[c][k])
                          for c in range(RING_LANES)]).astype(np.float32)
                for k in range(RING_STEPS)]

    def images(k):
        return rendered[k], np.full(RING_LANES, ts[k], np.float32)

    t_phase = time.perf_counter()
    runs, befores = [], []

    def keep(k, before, row):
        if len(runs) == 0:
            befores.append(before)

    for _ in range(2):
        fast_cuda.launches = 0
        with launch_record(fast_cuda) as recorded:
            state = init_multicam(cfg, RING_LANES, device=CARD, seed=0)
            state, rows, ms = run_lanes(torch, step, state, images,
                                        range(RING_STEPS), after=keep)
        launches = fast_cuda.launches
        shapes = launch_shapes(recorded)
        held, held_err = hold_launches(fast_ops, recorded, "lanes_ring")
        merged, ok, n_imp, merge_ms, peak = timed_merge(
            torch, merge, state.maps,
            merge_noise(RING_LANES, cfg.map.max_landmarks, seed=17))
        runs.append(dict(state=state, rows=rows, ms=ms, launches=launches,
                         shapes=shapes, held=held, held_err=held_err,
                         merged=merged, ok=ok.cpu().numpy(),
                         n_imp=n_imp.cpu().numpy(), merge_ms=merge_ms,
                         peak=peak))
    a, b = runs
    sa, sb = multicam_state_to_numpy(a["state"]), \
        multicam_state_to_numpy(b["state"])
    ma, mb = map_to_numpy(a["merged"]), map_to_numpy(b["merged"])
    replay = (np.array_equal(a["rows"], b["rows"])
              and all(np.array_equal(sa[f], sb[f]) for f in sa if f != "maps")
              and all(np.array_equal(sa["maps"][f], sb["maps"][f])
                      for f in sa["maps"])
              and all(np.array_equal(ma[f], mb[f]) for f in ma)
              and np.array_equal(a["ok"], b["ok"])
              and np.array_equal(a["n_imp"], b["n_imp"]))
    ates = lane_ates(a["rows"], ts, centres)
    imports = [import_structure(sa["maps"]["lm_valid"][c],
                                ma["lm_valid"][c], ma["lm_pos"][c],
                                ates[c][1], world.points)
               for c in range(RING_LANES)]
    ms = a["ms"] + b["ms"]
    res = dict(
        phase="lanes_ring", lanes=RING_LANES, steps=RING_STEPS,
        final_modes=a["rows"][-1, :, 0].astype(int).tolist(),
        kf_total=a["rows"][-1, :, 8].astype(int).tolist(),
        ate_m=[x for x, _ in ates],
        merge=dict(ok=a["ok"].tolist(), imported=a["n_imp"].tolist(),
                   import_median_to_structure_m=[m for _, m in imports],
                   ms=[a["merge_ms"], b["merge_ms"]],
                   peak_device_bytes=a["peak"]),
        fast_launches=[a["launches"], b["launches"]],
        launch_shapes=a["shapes"],
        launches_held_against_plain=[a["held"], b["held"]],
        held_max_abs_err=max(a["held_err"], b["held_err"]),
        replay_bit_equal=replay,
        median_ms_per_step=statistics.median(ms),
        median_ms_per_lane_step=statistics.median(ms) / RING_LANES,
        seconds=time.perf_counter() - t_phase)
    emit(res)
    if (a["rows"][-1, :, 0] != MODE_TRACKING).any():
        fail(f"lanes_ring: lanes not all TRACKING: {res['final_modes']}")
    if int(a["ok"].sum()) < RING_LANES - 1:
        fail(f"lanes_ring: {int(a['ok'].sum())} merges ok (< "
             f"{RING_LANES - 1})")
    if any(r[n] != RING_STEPS for r in runs for n in ("launches", "held")) \
            or a["shapes"] != [(RING_LANES, cfg.orb.n_levels)]:
        fail(f"lanes_ring: FAST launches {res['fast_launches']} of (lanes, "
             f"levels) {a['shapes']} for {RING_STEPS} steps (expected one "
             f"per step over {RING_LANES} lanes x {cfg.orb.n_levels} "
             "levels)")
    if not replay:
        fail("lanes_ring: the same-seed rerun is not bit-equal")
    afters = befores[1:] + [a["state"]]
    return res, dict(
        cfg=cfg, maps=a["state"].maps,
        noises=merge_noise(RING_LANES, cfg.map.max_landmarks, seed=17),
        merged=a["merged"], ok=a["ok"], n_imp=a["n_imp"],
        steps=[(befores[k], *images(k), afters[k], a["rows"][k])
               for k in range(RING_STEPS)])


def _lanes_of(torch, state, lanes, dev):
    """The lanes ``lanes`` of a MultiCamState as a state of their own,
    every tensor on ``dev`` (the generator states on the CPU)."""
    from send_slam_tpu_torch.models.map_state import MapState
    idx = torch.tensor(list(lanes))
    return state._replace(
        maps=MapState(**{f.name: getattr(state.maps, f.name)[idx.to(
            getattr(state.maps, f.name).device)].to(dev)
            for f in dataclasses.fields(MapState)}),
        rng=state.rng[idx],
        **{f: getattr(state, f)[idx.to(getattr(state, f).device)].to(dev)
           for f in state._fields if f not in ("maps", "rng")})


def _state_np(torch, state):
    """Every field of a MultiCamState as numpy, the maps' fields too."""
    from send_slam_tpu_torch.parallel.multicam import (
        multicam_state_to_numpy,
    )
    d = multicam_state_to_numpy(state)
    d.update({"maps." + f: v for f, v in d.pop("maps").items()})
    d["rng"] = state.rng.numpy()
    return d


def lanes_mixed_mesh(torch, cfg, kept):
    """C.3: lanes_ring's steps and merge on a mesh of the card and the
    CPU (four lanes on each; their slices move to the CPU and back as a
    two-card mesh moves them), each step from the one-card run's state
    before it. The moves, checked: the card's lanes equal the one-card
    run's bit for bit with every field back on the card, and the CPU's
    lanes equal a CPU mesh's run of the same lanes bit for bit. The
    merge, checked: each lane's equal to its merge on its own device,
    verdicts and imports equal the one-card run's. The devices, reported
    and not checked: the CPU's lanes against the one-card run at
    lanes_parity's bars, which a lane step at the parallax floor misses
    (an init decision, a commit's low-parallax landmarks; ROADMAP C.3)."""
    from send_slam_tpu_torch.parallel import make_mesh, multicam_slam_step
    from send_slam_tpu_torch.parallel.map_merge import (
        merge_from_partner, multicam_merge_step,
    )
    from send_slam_tpu_torch.parallel.multicam import lane_map
    t_phase = time.perf_counter()
    mesh = make_mesh(devices=list(MIXED_DEVICES))
    blocks = mesh.lane_blocks(RING_LANES)
    card, cpu_lanes = list(blocks[0][1]), list(blocks[1][1])
    step = multicam_slam_step(cfg, mesh)
    step_cpu = multicam_slam_step(cfg, make_mesh(1, devices=["cpu"]))
    exact_cols = [0, 2, 3, 7, 8, 9]
    moves_bad, beyond = [], []
    worst = dict(pose=0.0, inliers=0, ba_abs={f: 0.0 for f in BA_TOL})
    for k, (before, imgs, tss, after, row) in enumerate(kept["steps"]):
        st, summary = step(before, imgs, tss)
        mixed, one = _state_np(torch, st), _state_np(torch, after)
        cs_ = summary.cpu().numpy()
        devices = {str(getattr(st, f).device) for f in st._fields
                   if f not in ("maps", "rng")}
        devices |= {str(getattr(st.maps, f.name).device)
                    for f in dataclasses.fields(st.maps)}
        if not (all(np.array_equal(mixed[f][card], one[f][card])
                    for f in one)
                and np.array_equal(cs_[card], row[card])
                and devices == {"cuda:0"}):
            moves_bad.append(dict(step=k, lanes="card",
                                  devices=sorted(devices)))
        ref_cpu, row_cpu = step_cpu(_lanes_of(torch, before, cpu_lanes,
                                              "cpu"), imgs[cpu_lanes],
                                    tss[cpu_lanes])
        ref_cpu = _state_np(torch, ref_cpu)
        if not (all(np.array_equal(mixed[f][cpu_lanes], ref_cpu[f])
                    for f in ref_cpu)
                and np.array_equal(cs_[cpu_lanes], row_cpu.numpy())):
            moves_bad.append(dict(step=k, lanes="cpu"))
        # The CPU's lanes against the one-card run (lanes_parity's bars).
        g, c = one, mixed
        pose = max(_max_err(row[cpu_lanes][:, 4:7], cs_[cpu_lanes][:, 4:7]),
                   _max_err(g["R"][cpu_lanes], c["R"][cpu_lanes]),
                   _max_err(g["t"][cpu_lanes], c["t"][cpu_lanes]))
        d_inl = int(np.abs(row[cpu_lanes][:, 1] - cs_[cpu_lanes][:, 1]).max())
        ba = {f: _max_err(g["maps." + f][cpu_lanes], c["maps." + f][cpu_lanes])
              for f in BA_TOL}
        ints = [f for f in g if g[f].dtype.kind != "f" and f != "rng"]
        ints_same = all(np.array_equal(g[f][cpu_lanes], c[f][cpu_lanes])
                        for f in ints)
        if (np.array_equal(row[cpu_lanes][:, exact_cols],
                           cs_[cpu_lanes][:, exact_cols])
                and ints_same and d_inl <= 2 and pose <= 1e-4
                and all(ba[f] <= BA_TOL[f] for f in BA_TOL)):
            worst = dict(pose=max(worst["pose"], pose),
                         inliers=max(worst["inliers"], d_inl),
                         ba_abs={f: max(worst["ba_abs"][f], ba[f])
                                 for f in BA_TOL})
        else:
            beyond.append(dict(
                step=k, lanes=[c_ for c_ in cpu_lanes
                               if not np.array_equal(row[c_], cs_[c_])],
                ints_differ=[f for f in ints if not np.array_equal(
                    g[f][cpu_lanes], c[f][cpu_lanes])],
                pose=pose, inliers=d_inl, ba_abs=ba,
                rows_one_card=row[cpu_lanes].tolist(),
                rows_mixed=cs_[cpu_lanes].tolist()))
    merged, ok_m, n_m = multicam_merge_step(cfg, mesh)(kept["maps"],
                                                      kept["noises"])
    maps, noises, tr = kept["maps"], kept["noises"], cfg.tracking
    merge_moves = True
    for k in range(RING_LANES):
        j = (k + 1) % RING_LANES
        dev = "cuda" if k in blocks[0][1] else "cpu"
        ref = merge_from_partner(lane_map(maps, k, dev),
                                 maps.lm_pos[j].to(dev),
                                 maps.lm_desc[j].to(dev),
                                 maps.lm_valid[j].to(dev), noises[k], tr)
        merge_moves &= (bool(ok_m[k].cpu() == ref[1].cpu())
                        and bool(n_m[k].cpu() == ref[2].cpu())
                        and all(getattr(merged, f.name)[k].cpu().equal(
                            getattr(ref[0], f.name).cpu())
                            for f in dataclasses.fields(ref[0])))
    verdicts_equal = (np.array_equal(ok_m.cpu().numpy(), kept["ok"])
                      and np.array_equal(n_m.cpu().numpy(), kept["n_imp"]))
    res = dict(phase="lanes_mixed_mesh", devices=list(MIXED_DEVICES),
               lane_blocks=[[str(d), list(r)] for d, r in blocks],
               steps=len(kept["steps"]),
               moves_bit_equal=not moves_bad, moves_beyond=moves_bad,
               merge_moves_bit_equal=merge_moves,
               cpu_lanes_vs_one_card=dict(
                   tolerances=dict(step_integers="exact", inliers=2,
                                   poses=1e-4, ba_fields_abs=BA_TOL),
                   lane_steps=len(kept["steps"]) * len(cpu_lanes),
                   steps_within=len(kept["steps"]) - len(beyond),
                   worst_within=worst, steps_beyond=beyond),
               merge_ok=ok_m.cpu().tolist(), merge_imported=n_m.cpu().tolist(),
               merge_verdicts_equal_one_card=verdicts_equal,
               seconds=time.perf_counter() - t_phase)
    emit(res)
    if moves_bad:
        fail(f"lanes_mixed_mesh: the mixed mesh's lanes differ from their "
             f"own device's run, or came back elsewhere: {moves_bad[:3]}")
    if not merge_moves:
        fail("lanes_mixed_mesh: the mixed merge differs from each lane's "
             "merge on its own device")
    if not verdicts_equal:
        fail(f"lanes_mixed_mesh: merge verdicts {res['merge_ok']} and imports "
             f"{res['merge_imported']} differ from the one-card run's")
    return res


def scale_path(torch, System, fast_cuda):
    """The main path's frames at ``OrbConfig(scale_factor=1.3)``, every
    other option flagship: the pyramid resampled at odd level shapes,
    one FAST launch per make_frame over them."""
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.ops.pyramid import level_shapes
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    base = flagship_config()
    cfg = base.replace(orb=dataclasses.replace(
        base.orb, scale_factor=SCALE_PATH_SCALE))
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=N_FRAMES)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(N_FRAMES)]
    system = System(cfg, device="cuda")
    system.frames_extracted = 0
    fast_cuda.launches = 0
    run = drive(torch, system, frames, ts)
    launches = fast_cuda.launches
    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])
    est_ts, pos = run["est_ts"], run["est_pos"]
    tracked = len(est_ts)
    ate = ate_rmse(est_ts, pos, ts, gt) if tracked >= 3 else float("inf")
    res = dict(
        phase="scale_path", scale_factor=SCALE_PATH_SCALE,
        level_shapes=[list(x) for x in level_shapes(480, 640, 8,
                                                     SCALE_PATH_SCALE)],
        frames=N_FRAMES, tracked=tracked, tracked_live=run["live"],
        backfilled=run["backfilled"], init_commit_ts=system.init_commit_ts,
        keyframes=run["keyframes"], landmarks=run["landmarks"], ate_m=ate,
        frames_through_make_frame=system.frames_extracted,
        fast_launches=launches,
        median_ms_per_tracked_frame=(statistics.median(run["t_ok"][1:])
                                     if len(run["t_ok"]) > 1 else None),
        seconds=run["seconds"])
    emit(res)
    if launches != system.frames_extracted or launches == 0:
        fail(f"scale_path: {launches} FAST launches for "
             f"{system.frames_extracted} make_frame calls")
    if tracked < MIN_TRACKED or not np.isfinite(ate):
        fail(f"scale_path: tracked {tracked} of {N_FRAMES} (< {MIN_TRACKED})"
             f" or ATE {ate}")
    return res


def png_bytes(img: np.ndarray, filters=(0,)) -> bytes:
    """An 8-bit PNG of (H, W) gray or (H, W, 3) RGB, its rows filtered
    with ``filters`` in turn (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth),
    one IDAT. This script's own writer: the port reads PNG but writes
    none."""
    import struct
    import zlib
    img = np.asarray(img, np.uint8)
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, -1).astype(np.int32)
    up = np.vstack([np.zeros((1, x.shape[1]), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), x[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) >> 1, paeth)
    ftype = np.asarray(filters)[np.arange(h) % len(filters)]
    rows = np.empty((h, x.shape[1] + 1), np.uint8)
    rows[:, 0] = ftype
    for f in set(ftype.tolist()):
        sel = ftype == f
        rows[sel, 1:] = (x[sel] - (preds[f][sel] if f else 0)) & 0xFF

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", img.shape[1], h, 8,
                         0 if img.ndim == 2 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def write_tum(root, frames, ts, Rs, tls):
    """A TUM RGB-D tree as tests/test_dataset_e2e.py writes it: comment
    headers, rgb/<stamp>.png as 8-bit RGB (gray in three channels),
    stamps TUM_T0 + t, groundtruth.txt at twice the frame rate, late by
    TUM_GT_OFFSET."""
    from scipy.spatial.transform import Rotation
    os.makedirs(os.path.join(root, "rgb"))
    lines = ["# color images", "# file: 'synthetic.bag'",
             "# timestamp filename"]
    for k, t in enumerate(ts):
        rel = f"rgb/{TUM_T0 + t:.6f}.png"
        with open(os.path.join(root, rel), "wb") as f:
            f.write(png_bytes(np.repeat(frames[k][..., None], 3, 2),
                              TUM_FILTERS))
        lines.append(f"{TUM_T0 + t:.6f} {rel}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    gt = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for k, t in enumerate(ts):
        for half in (0.0, 0.5):
            if half and k + 1 >= len(ts):
                continue
            C = -Rs[k].T @ tls[k]
            q = Rotation.from_matrix(Rs[k].T).as_quat()
            gt.append(f"{TUM_T0 + t + half / 30.0 + TUM_GT_OFFSET:.6f} "
                      f"{C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
                      f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt) + "\n")


def write_euroc(root, frames, ts, Rs, tls):
    """An EuRoC MAV tree: mav0/cam0/data.csv in ns and 8-bit gray
    data/<ns>.png, the 17-column state_groundtruth_estimate0/data.csv
    (position in columns 1-3)."""
    data = os.path.join(root, "mav0", "cam0", "data")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(data)
    os.makedirs(gt_dir)
    cam = ["#timestamp [ns],filename"]
    gt = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], ..."]
    for k, t in enumerate(ts):
        ns = int(round((EUROC_T0 + t) * 1e9))
        with open(os.path.join(data, f"{ns}.png"), "wb") as f:
            f.write(png_bytes(frames[k], EUROC_FILTERS))
        cam.append(f"{ns},{ns}.png")
        C = -Rs[k].T @ tls[k]
        gt.append(f"{ns},{C[0]},{C[1]},{C[2]}," + ",".join(["0.0"] * 13))
    with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("\n".join(cam) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(gt) + "\n")


def dataset_session(torch, System, fast_cuda, fast_ops, name, root, cfg,
                    frames, true_ts, hold=False):
    """Open the tree at ``root`` as a user would (open_sequence), decode
    every frame (each must equal the frame written, each stamp lie within
    1e-6 s of ``true_ts``), track them all on the card, counted as
    bench.py counts, and score the ATE against the ground truth parsed
    from disk. ``hold``: every FAST launch of the run is held against
    the plain version afterwards. Returns the phase's result and the
    run."""
    from send_slam_tpu_torch.io.dataset import open_sequence
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    t0 = time.perf_counter()
    seq = open_sequence(root)
    decoded = list(seq)
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(len(decoded), 1)
    if len(decoded) != len(frames):
        fail(f"{name}: {len(decoded)} frames decoded of {len(frames)}")
    for k, ((_, img), ref) in enumerate(zip(decoded, frames)):
        if img.dtype != np.uint8 or not np.array_equal(img, ref):
            fail(f"{name}: decoded frame {k} differs from the frame written")
    ts = np.asarray([t for t, _ in decoded])
    ts_err = float(np.abs(ts - np.asarray(true_ts)).max())
    if ts_err > 1e-6:
        fail(f"{name}: parsed stamps {ts_err} s from the written ones")
    gt_ts, gt_pos = seq.gt_positions()
    system = System(cfg, device="cuda")
    system.frames_extracted = 0
    fast_cuda.launches = 0
    with launch_record(fast_cuda) as launches:
        run = drive(torch, system, [img for _, img in decoded], ts)
    n_launches = fast_cuda.launches
    held = hold_launches(fast_ops, launches, name) if hold else (0, 0.0)
    est_ts, pos = run["est_ts"], run["est_pos"]
    tracked = len(est_ts)
    ate = (ate_rmse(est_ts, pos, gt_ts, gt_pos) if tracked >= 3
           else float("inf"))
    res = dict(
        phase=name, layout=type(seq).__name__, frames=len(decoded),
        shape=list(decoded[0][1].shape), png_decode_ms_per_frame=decode_ms,
        stamp_max_err_s=ts_err, gt_rows=int(len(gt_ts)),
        tracked=tracked, tracked_live=run["live"],
        backfilled=run["backfilled"], init_commit_ts=system.init_commit_ts,
        keyframes=run["keyframes"], landmarks=run["landmarks"], ate_m=ate,
        frames_through_make_frame=system.frames_extracted,
        fast_launches=n_launches, launches_held_against_plain=held[0],
        held_max_abs_err=held[1],
        median_ms_per_tracked_frame=(statistics.median(run["t_ok"][1:])
                                     if len(run["t_ok"]) > 1 else None),
        seconds=run["seconds"])
    emit(res)
    if n_launches != system.frames_extracted or n_launches == 0:
        fail(f"{name}: {n_launches} FAST launches for "
             f"{system.frames_extracted} make_frame calls")
    if hold and held[0] != n_launches:
        fail(f"{name}: {held[0]} of {n_launches} launches held")
    if tracked < MIN_TRACKED or not ate <= DATASET_MAX_ATE:
        fail(f"{name}: tracked {tracked} of {len(frames)} (< {MIN_TRACKED})"
             f" or ATE {ate} m (> {DATASET_MAX_ATE})")
    return res, run


def start_example(root: str, outdir: str):
    """examples/run_dataset_torch.py over EXAMPLE_FRAMES frames of the TUM
    tree, started as a user starts it (its CPU threads capped as this
    script's processes are), to run beside the other offline phases."""
    here = os.path.dirname(os.path.abspath(__file__))
    traj = os.path.join(outdir, "example_kf.txt")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "examples",
                                      "run_dataset_torch.py"),
         root, "--max-frames", str(EXAMPLE_FRAMES), "--traj-out", traj],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS=str(OFFLINE_THREADS)))
    _CHILDREN.append(proc)
    return proc, traj, time.perf_counter()


def dataset_example(started):
    """The example's run of start_example: exit code 0, its frames line
    for EXAMPLE_FRAMES frames, an ATE line, a keyframe file of one TUM
    line per keyframe it reports. No accuracy bar: the example imposes
    FR1's distorted intrinsics on undistorted synthetic frames."""
    proc, traj, t0 = started
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("dataset_example: the example ran past 240 s")
    seconds = time.perf_counter() - t0
    m = re.search(r"^frames: (\d+), tracked: (\d+), [\d.]+ fps, "
                  r"keyframes: (\d+), landmarks: \d+, loops: \d+$", out, re.M)
    ate = re.search(r"^(ATE RMSE: \S+ m|no ground truth available)$",
                    out, re.M)
    rows = []
    if os.path.exists(traj):
        with open(traj) as f:
            rows = [ln.split() for ln in f if ln.strip()]
    parsed = all(len(r) == 8 and all(_is_float(v) for v in r) for r in rows)
    res = dict(phase="dataset_example", rc=proc.returncode,
               frames_line=m.group(0) if m else None,
               ate_line=ate.group(0) if ate else None,
               keyframe_lines=len(rows), seconds_beside_18_to_20=seconds,
               note="FR1's distorted intrinsics on undistorted synthetic "
                    "frames: no accuracy bar")
    emit(res)
    if proc.returncode != 0:
        fail(f"dataset_example exited {proc.returncode}:\n{err[-3000:]}")
    if m is None or int(m.group(1)) != EXAMPLE_FRAMES or ate is None:
        fail(f"dataset_example printed no frames line for {EXAMPLE_FRAMES} "
             f"frames or no ATE line:\n{out[-2000:]}")
    if not parsed or len(rows) != int(m.group(3)):
        fail(f"dataset_example: {len(rows)} keyframe lines (all TUM: "
             f"{parsed}) for {m.group(3)} keyframes")
    return res


def _is_float(v: str) -> bool:
    try:
        float(v)
    except ValueError:
        return False
    return True


def textured_path(torch, System, fast_cuda):
    """tests/test_stress_e2e.py's flagship lap: the textured room with its
    whole nuisance stack, 120 frames of one lap, each rendered just
    before it is tracked (the renders are stateful and taken in order)."""
    from send_slam_tpu_torch.config import (
        CameraConfig, EngineConfig, MapConfig, TrackingConfig,
    )
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.utils.synth import TexturedWorld
    world = TexturedWorld(seed=11, width=640, height=480, fx=520.0,
                          fy=520.0, **TEXTURED_KNOBS)
    ts, Rs, tls = world.trajectory_laps(n_frames=TEXTURED_FRAMES, laps=1.0)
    cfg = EngineConfig(
        camera=CameraConfig(width=640, height=480, fx=520.0, fy=520.0,
                            cx=320.0, cy=240.0),
        map=MapConfig(max_keyframes=64, max_landmarks=8192, ba_window=8),
        tracking=TrackingConfig(init_min_matches=50, pipeline_stretch=1))
    system = System(cfg, device="cuda")
    system.frames_extracted = 0
    fast_cuda.launches = 0
    run = drive(torch, system, Rendered(world, zip(Rs, tls)), ts)
    launches = fast_cuda.launches
    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])
    est_ts, pos = run["est_ts"], run["est_pos"]
    tracked = len(est_ts)
    ate = ate_rmse(est_ts, pos, ts, gt) if tracked >= 3 else float("inf")
    res = dict(
        phase="textured_path", frames=TEXTURED_FRAMES, knobs=TEXTURED_KNOBS,
        tracked=tracked, tracked_live=run["live"],
        backfilled=run["backfilled"], init_commit_ts=system.init_commit_ts,
        keyframes=run["keyframes"], landmarks=run["landmarks"], ate_m=ate,
        frames_through_make_frame=system.frames_extracted,
        fast_launches=launches,
        median_ms_per_tracked_frame=(statistics.median(run["t_ok"][1:])
                                     if len(run["t_ok"]) > 1 else None),
        seconds_with_rendering=run["seconds"])
    emit(res)
    if launches != system.frames_extracted or launches == 0:
        fail(f"textured_path: {launches} FAST launches for "
             f"{system.frames_extracted} make_frame calls")
    if not (tracked > TEXTURED_MIN_OK and ate < TEXTURED_MAX_ATE
            and run["keyframes"] < TEXTURED_FRAMES // 2):
        fail(f"textured_path: tracked {tracked} of {TEXTURED_FRAMES} (bar "
             f"> {TEXTURED_MIN_OK}), ATE {ate} m (bar < {TEXTURED_MAX_ATE}),"
             f" {run['keyframes']} keyframes (bar < {TEXTURED_FRAMES // 2})")
    return res


def offline_vs_main(run, main_res, offline, npz):
    """dataset_tum against phase 5 (the same images; only the stamps
    differ, epoch seconds parsed from text against k / 30): tracked,
    keyframes, the frames each emits that the other does not, poses
    emitted twice, and the largest distance between the two runs'
    positions of one frame, which must stay within OFFLINE_POS_TOL m
    with the keyframe counts equal; textured_path's and the main path's
    median ms per tracked frame."""
    got = np.load(npz)
    tum = [int(round(t * 30.0)) for t in got["est_ts"]]
    main = [int(round(t * 30.0)) for t in run["est_ts"]]
    ours = dict(zip(tum, got["est_pos"]))
    theirs = dict(zip(main, run["est_pos"]))
    common = sorted(set(ours) & set(theirs))
    diff = (max(float(np.linalg.norm(ours[k] - theirs[k])) for k in common)
            if common else float("inf"))
    res = dict(
        dataset_tum_tracked=len(tum), main_path_tracked=len(main),
        dataset_tum_keyframes=offline["dataset_tum"]["keyframes"],
        main_path_keyframes=run["keyframes"],
        dataset_tum_init_commit_ts=offline["dataset_tum"]["init_commit_ts"],
        main_path_init_commit_ts=main_res["init_commit_ts"],
        frames_only_in_dataset_tum=sorted(set(ours) - set(theirs)),
        frames_only_in_main_path=sorted(set(theirs) - set(ours)),
        frames_emitted_twice=dict(
            dataset_tum=sorted({k for k in tum if tum.count(k) > 1}),
            main_path=sorted({k for k in main if main.count(k) > 1})),
        common_frames=len(common), max_position_diff_m=diff,
        textured_median_ms_per_tracked_frame=offline["textured_path"][
            "median_ms_per_tracked_frame"],
        main_path_median_ms_per_tracked_frame=main_res[
            "median_ms_per_tracked_frame"])
    emit(dict(phase="offline_vs_main", **res))
    if not (diff <= OFFLINE_POS_TOL and res["dataset_tum_keyframes"]
            == res["main_path_keyframes"]):
        fail(f"dataset_tum parts from the main path: positions {diff} m "
             f"apart (> {OFFLINE_POS_TOL}) or keyframes "
             f"{res['dataset_tum_keyframes']} against "
             f"{res['main_path_keyframes']}")
    return res


def offline_main(outdir: str) -> int:
    """The offline-evaluation phases in a process of their own, which
    main() starts with the other three after the server phases (the
    example in a process of its own beside dataset_tum, dataset_euroc
    and textured_path): their JSON lines go to standard output,
    dataset_tum's streamed poses to ``outdir/offline.npz``."""
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    atexit.register(_stop_children)       # the example, if a check fails
    import torch
    torch.set_num_threads(OFFLINE_THREADS)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from send_slam_tpu_torch.config import CameraConfig, EngineConfig
    from send_slam_tpu_torch.models.system import System
    from send_slam_tpu_torch.ops import fast as fast_ops
    from send_slam_tpu_torch.ops import fast_cuda
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    fast_cuda.load()
    for name, w, h, fx, fy, t0, write in (
            ("dataset_tum", 640, 480, 520.0, 520.0, TUM_T0, write_tum),
            ("dataset_euroc", EUROC_W, EUROC_H, EUROC_FX, EUROC_FY,
             EUROC_T0, write_euroc)):
        world = SyntheticWorld(n_points=900, width=w, height=h, fx=fx,
                               fy=fy, seed=11)
        ts, Rs, tls = world.trajectory(n_frames=N_FRAMES)
        frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
                  for k in range(N_FRAMES)]
        root = os.path.join(outdir, name)
        write(root, frames, ts, Rs, tls)
        if name == "dataset_tum":
            example = start_example(root, outdir)
        cfg = EngineConfig(camera=CameraConfig(
            width=w, height=h, fx=fx, fy=fy, cx=world.cx, cy=world.cy))
        _, run = dataset_session(torch, System, fast_cuda, fast_ops, name,
                                 root, cfg, frames, t0 + ts,
                                 hold=name == "dataset_euroc")
        if name == "dataset_tum":
            np.savez(os.path.join(outdir, "offline.npz"),
                     est_ts=np.asarray(run["est_ts"]) - TUM_T0,
                     est_pos=run["est_pos"])
    textured_path(torch, System, fast_cuda)
    dataset_example(example)
    return 0


def render_board(torch, rvec, tvec, noise=0.0, seed=0):
    """tests/test_calibration.py's render_board without cv2: the
    checkerboard plane (z = 0) seen by CALIB_K with CALIB_DIST, rendered
    by inverse warp, blurred by the port's gaussian_blur at (5, 1.0) on
    the CPU where that test calls cv2.GaussianBlur((5, 5), 1.0)."""
    from scipy.spatial.transform import Rotation
    from send_slam_tpu_torch.ops.pyramid import gaussian_blur
    R = Rotation.from_rotvec(rvec).as_matrix()
    t = np.asarray(tvec, float)
    us, vs = np.meshgrid(np.arange(640), np.arange(480))
    x = (us - CALIB_K[0, 2]) / CALIB_K[0, 0]
    y = (vs - CALIB_K[1, 2]) / CALIB_K[1, 1]
    k1, k2, p1, p2, k3 = CALIB_DIST
    xn, yn = x.copy(), y.copy()
    for _ in range(10):
        r2 = xn * xn + yn * yn
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
        dy = p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
        xn = (x - dx) / radial
        yn = (y - dy) / radial
    Rinv = R.T
    rays = np.stack([xn, yn, np.ones_like(xn)], -1)
    denom = rays @ Rinv.T[:, 2]
    lam = (Rinv @ t)[2] / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    Xb = np.einsum('ij,hwj->hwi', Rinv, lam[..., None] * rays - t)
    bx, by = Xb[..., 0] / CALIB_SQUARE, Xb[..., 1] / CALIB_SQUARE
    cols, rows = CALIB_PATTERN
    inside = (bx > -1) & (bx < cols) & (by > -1) & (by < rows) & (lam > 0)
    checker = ((np.floor(bx) + np.floor(by)) % 2 == 0)
    img = np.where(inside, np.where(checker, 235.0, 25.0), 230.0)
    img = gaussian_blur(torch.from_numpy(img.astype(np.float32)), 1.0,
                        5).numpy()
    if noise:
        img = img + np.random.default_rng(seed).normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def board_views(torch):
    """tests/test_calibration.py's board_views: CALIB_VIEWS views that
    keep the whole board in sight, sensor noise 0.5."""
    rng = np.random.default_rng(42)
    cx_b = CALIB_PATTERN[0] * CALIB_SQUARE / 2
    cy_b = CALIB_PATTERN[1] * CALIB_SQUARE / 2
    views = []
    for i in range(CALIB_VIEWS):
        rvec = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.35, 0.35),
                         rng.uniform(-0.5, 0.5)])
        tvec = np.array([-cx_b + rng.uniform(-40, 40),
                         -cy_b + rng.uniform(-30, 30),
                         rng.uniform(420, 650)])
        views.append(render_board(torch, rvec, tvec, 0.5, i))
    return views


def calibration(torch):
    """Calibration on the card: detect_checkerboard and calibrate on the
    board views, card against CPU, recovered focal lengths against the
    truth; then GET /panel of an ``Application`` replaying the boards:
    PANEL_FRAMES JPEG frames sent back as the calibration upload must be
    answered "OK", write the calibration JSON and publish CALIBRATION
    once."""
    from send_slam_tpu_torch.calib.checkerboard import detect_checkerboard
    from send_slam_tpu_torch.calib.io import ENV_VAR, load_from_file
    from send_slam_tpu_torch.calib.pipeline import calibrate
    from send_slam_tpu_torch.config import ServerConfig
    from send_slam_tpu_torch.io.jpeg import decode_jpeg_gray, encode_jpeg
    from send_slam_tpu_torch.io.ppm import encode_ppm
    from send_slam_tpu_torch.server import bus as topics
    from send_slam_tpu_torch.server.app import Application
    t_phase = time.perf_counter()
    views = board_views(torch)
    corners, det_ms, cal, cal_ms = {}, {}, {}, {}
    for dev in ("cuda", "cpu", "cuda"):      # the card twice: warm, timed
        t0 = time.perf_counter()
        corners[dev] = [detect_checkerboard(v, CALIB_PATTERN, device=dev)
                        for v in views]
        t1 = time.perf_counter()
        cal[dev] = calibrate(views, CALIB_PATTERN, CALIB_SQUARE, device=dev)
        t2 = time.perf_counter()
        det_ms[dev] = (t1 - t0) / len(views) * 1e3
        cal_ms[dev] = (t2 - t1) * 1e3
    found = {d: [c is not None for c in corners[d]] for d in corners}
    corner_err = max((_max_err(a, b) for a, b in zip(corners["cuda"],
                                                      corners["cpu"])
                      if a is not None and b is not None), default=0.0)
    Kg, Kc = cal["cuda"]["camera_matrix"], cal["cpu"]["camera_matrix"]
    k_rel = float(np.abs(Kg - Kc).max() / np.abs(Kc).max())
    f_rel = {d: [abs(cal[d]["camera_matrix"][i, i] - CALIB_K[i, i])
                 / CALIB_K[i, i] for i in (0, 1)] for d in cal}
    rgb = np.repeat(np.round(views[0]).astype(np.uint8)[..., None], 3, 2)
    jpeg = encode_jpeg(rgb)
    enc_ms = host_ms(lambda: encode_jpeg(rgb), 20)
    dec_ms = host_ms(lambda: decode_jpeg_gray(jpeg), 20)

    # /panel of an Application replaying the boards (no engine).
    seq = tempfile.mkdtemp(prefix="chip_smoke_boards_")
    atexit.register(shutil.rmtree, seq, ignore_errors=True)
    for k, v in enumerate(views):
        with open(os.path.join(seq, f"{k:06d}.ppm"), "wb") as f:
            f.write(encode_ppm(np.repeat(np.round(v).astype(np.uint8)
                                         [..., None], 3, 2)))
    out_path = os.path.join(seq, "calibration", "latest.json")
    os.environ[ENV_VAR] = out_path
    base = flagship_config()
    cfg = base.replace(
        camera=dataclasses.replace(base.camera, fps=PANEL_FPS),
        server=ServerConfig(http_port=0, tcp_port=0))
    count = dict(camera=0, skipped=0, calibration=0)

    async def go():
        app = Application(config=cfg, video=os.path.join(seq, "%06d.ppm"),
                          run_engine=False, run_tcp=False, run_web=True,
                          device="cuda")
        publish = app.bus.publish

        def counted(topic, msg):
            subs = app.bus._subs.get(topics.CAMERA, ())
            if topic == topics.CAMERA and subs:
                count["camera"] += 1
                count["skipped"] += sum(q.full() for q in subs)
            elif topic == topics.CALIBRATION:
                count["calibration"] += 1
            publish(topic, msg)

        app.bus.publish = counted
        await app.start()
        try:
            ws = await WsClient.connect(app.web.bound_port, "/panel")
            jpegs = []
            while len(jpegs) < PANEL_FRAMES:
                op, data = await asyncio.wait_for(ws.recv(), 30)
                if op == 0x2:
                    jpegs.append(data)
            upload = json.dumps({"calibrationFrames": [
                "data:image/jpeg;base64," + base64.b64encode(j).decode()
                for j in jpegs]}).encode()
            t0 = time.perf_counter()
            await ws.send(0x1, upload)
            while True:
                op, data = await asyncio.wait_for(ws.recv(), 120)
                if op == 0x1:
                    break
            reply_ms = (time.perf_counter() - t0) * 1e3
            sent = app.web.frames_sent
            await ws.close()
        finally:
            await app.stop()
        return data.decode(), reply_ms, sent, len(upload), jpegs

    reply, reply_ms, sent, upload_bytes, jpegs = asyncio.run(
        asyncio.wait_for(go(), 180))
    saved = load_from_file(out_path) if os.path.exists(out_path) else None
    res = dict(
        phase="calibration", views=CALIB_VIEWS, pattern=list(CALIB_PATTERN),
        found=found, corner_err_px=corner_err, K_rel_err=k_rel,
        K=dict(cuda=Kg.tolist(), cpu=Kc.tolist()),
        distortion=dict(cuda=cal["cuda"]["distortion_coeffs"].tolist(),
                        cpu=cal["cpu"]["distortion_coeffs"].tolist()),
        f_rel_err_to_truth=f_rel,
        reprojection_px={d: cal[d]["reprojection_error"] for d in cal},
        detect_ms_per_view=det_ms, calibrate_ms=cal_ms,
        jpeg=dict(bytes=len(jpeg), encode_ms=enc_ms, decode_ms=dec_ms,
                  shape=list(rgb.shape)),
        panel=dict(reply=reply, reply_ms=reply_ms, upload_bytes=upload_bytes,
                   jpeg_bytes=[len(j) for j in jpegs],
                   frames_published_while_open=count["camera"],
                   frames_sent=sent, frames_skipped=count["skipped"],
                   calibration_publishes=count["calibration"],
                   saved=saved is not None,
                   saved_K=(saved["camera_matrix"].tolist()
                            if saved is not None else None)),
        seconds=time.perf_counter() - t_phase)
    emit(res)
    if found["cuda"] != found["cpu"] or not all(found["cpu"]):
        fail(f"calibration: detections card {found['cuda']} CPU "
             f"{found['cpu']}")
    if corner_err > CALIB_CORNER_TOL or k_rel > CALIB_K_REL:
        fail(f"calibration: card vs CPU corners {corner_err} px (bar "
             f"{CALIB_CORNER_TOL}), K {k_rel} relative (bar {CALIB_K_REL})")
    if max(max(v) for v in f_rel.values()) > CALIB_F_REL:
        fail(f"calibration: fx, fy off the truth by {f_rel} (bar "
             f"{CALIB_F_REL})")
    if reply != "OK" or saved is None or count["calibration"] != 1:
        fail(f"calibration: /panel answered {reply!r}, saved "
             f"{saved is not None}, {count['calibration']} CALIBRATION "
             "publishes")
    if saved["camera_matrix"].shape != (3, 3) \
            or saved["distortion_coeffs"].shape != (1, 5):
        fail("calibration: the saved JSON is not in the reference layout")
    return res


def lanes_main(outdir: str, ring: bool) -> int:
    """Phases 15 and 16, or with ``ring`` phase 17, in a process of
    their own, which main() starts with the sessions process: their JSON
    lines go to standard output."""
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    import torch
    torch.set_num_threads(RING_THREADS if ring else LANES_THREADS)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from send_slam_tpu_torch.ops import fast_cuda
    fast_cuda.load()
    if ring:
        _, kept = lanes_ring(torch, fast_cuda)
        lanes_mixed_mesh(torch, kept["cfg"], kept)
        calibration(torch)
    else:
        _, kept = lanes_path(torch, fast_cuda)
        lanes_parity(torch, kept)
    return 0


# ---------------------------------------------------------------------------
# The server entry points: a WebSocket and HTTP client of this script's
# own, the drop-in backend against a host played here, the application.

WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


async def _read_head(reader):
    """An HTTP response head -> (status, {lower-cased name: value})."""
    lines = (await reader.readuntil(b"\r\n\r\n")).decode(
        "latin-1").split("\r\n")
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return int(lines[0].split(" ")[1]), headers


async def http_get(port, path, host="127.0.0.1"):
    """GET over a raw connection -> (status, body)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                     "Connection: close\r\n\r\n".encode())
        await writer.drain()
        status, headers = await _read_head(reader)
        n = headers.get("content-length")
        body = await (reader.readexactly(int(n)) if n is not None
                      else reader.read())
        return status, body
    finally:
        writer.close()


class WsClient:
    """A WebSocket client on a raw asyncio connection (RFC 6455): the
    handshake with its accept key checked, masked frames out, unmasked
    frames in."""

    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer

    @classmethod
    async def connect(cls, port, path, host="127.0.0.1"):
        reader, writer = await asyncio.open_connection(host, port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        await writer.drain()
        status, headers = await _read_head(reader)
        want = base64.b64encode(
            hashlib.sha1(key.encode() + WS_GUID).digest()).decode()
        if status != 101 or headers.get("sec-websocket-accept") != want:
            writer.close()
            raise ConnectionError(f"WebSocket handshake refused ({status}, "
                                  f"{headers})")
        return cls(reader, writer)

    async def send(self, opcode, payload=b"", fin=True):
        """One masked frame; ``fin=False`` leaves the message open (a
        fragment, continued by frames of opcode 0)."""
        n, mask = len(payload), os.urandom(4)
        b0 = (0x80 if fin else 0) | opcode
        if n < 126:
            head = bytes([b0, 0x80 | n])
        elif n < 1 << 16:
            head = bytes([b0, 0x80 | 126]) + n.to_bytes(2, "big")
        else:
            head = bytes([b0, 0x80 | 127]) + n.to_bytes(8, "big")
        key = int.from_bytes((mask * (n // 4 + 1))[:n], "big")
        body = (int.from_bytes(payload, "big") ^ key).to_bytes(n, "big")
        self.writer.write(head + mask + body)
        await self.writer.drain()

    async def recv(self):
        """The next frame: (opcode, payload). Server frames must be
        unmasked and final."""
        b0, b1 = await self.reader.readexactly(2)
        if b1 & 0x80 or not b0 & 0x80:
            raise ConnectionError(f"bad server frame header {b0:#x} {b1:#x}")
        n = b1 & 0x7F
        if n >= 126:
            n = int.from_bytes(
                await self.reader.readexactly(2 if n == 126 else 8), "big")
        return b0 & 0x0F, await self.reader.readexactly(n)

    async def recv_text(self):
        op, payload = await self.recv()
        if op != 0x1:
            raise ConnectionError(f"expected a text frame, got opcode {op}")
        return payload.decode("utf-8")

    async def close(self, code=1000):
        """Send a close frame and read frames until the server's close
        comes back; returns its code."""
        await self.send(0x8, code.to_bytes(2, "big"))
        try:
            while True:
                op, payload = await self.recv()
                if op == 0x8:
                    return int.from_bytes(payload[:2], "big")
        finally:
            self.writer.close()


def server_path(torch, System, fast_cuda, frames, ts, run, kernel_build_s):
    """Phase 5a: the drop-in backend (``BackendClient``) on the card,
    dialling the reference's host played here on a loopback listener:
    the calibration packet of the flagship camera, then phase 5's frames
    as the host sends them (P6, each gray value in three channels), one
    at a time, each after the backend has tracked the one before, then
    ``terminate``. Every pose packet must equal the main path's, bit for
    bit, in the backend's order; the backend warms up first."""
    from send_slam_tpu_torch.io import msgpack_codec, native
    from send_slam_tpu_torch.io.protocol import (
        PacketDecoder, build_calibration_packet, build_frame_packet,
        build_terminate_packet, frame_packet_bytes,
    )
    from send_slam_tpu_torch.models.system import TRACKING_OK
    from send_slam_tpu_torch.server import backend_client as bc
    os.environ.pop("SLAM_SKIP_WARMUP", None)    # the entry point's default
    cam = flagship_config().camera
    n = len(frames)
    # The host's side of the wire, per frame: P6 encoding, packing; the
    # backend's unpacking and fused decode + luma, timed here alone.
    t0 = time.perf_counter()
    ppms = [native.encode_ppm(np.repeat(f[..., None], 3, axis=2))
            for f in frames]
    t1 = time.perf_counter()
    wire = [frame_packet_bytes(build_frame_packet(
        0, float(ts[k]), cam.width, cam.height, ppms[k])) for k in range(n)]
    t2 = time.perf_counter()
    bodies = [msgpack_codec.unpackb(w[4:]) for w in wire]
    t3 = time.perf_counter()
    grays = [native.decode_ppm_gray(b["frame"]) for b in bodies]
    t4 = time.perf_counter()
    host = dict(rgb_ppm_encode_ms=(t1 - t0) / n * 1e3,
                pack_ms=(t2 - t1) / n * 1e3, unpack_ms=(t3 - t2) / n * 1e3,
                decode_gray_ms=(t4 - t3) / n * 1e3)
    decode_exact = all(np.array_equal(g, f) for g, f in zip(grays, frames))
    calib = frame_packet_bytes(build_calibration_packet(
        0, 0.0, cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
        fps=cam.fps))
    warm, sig = {}, {}

    step_ms = {n: [] for n in REPLAY_TIMED}

    class Served(System):
        """The backend's System: its warmup timed, the end of the warmup
        and each frame's output signalled to the host's event loop, and
        after the warmup each call of REPLAY_TIMED timed between two
        device syncs (numerics untouched)."""

        def _timed(self, name, fn, *a, **kw):
            if "first_s" not in warm:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t) * 1e3)
            return out

        def _backfill_step(self, *a, **kw):
            return self._timed("_backfill_step", super()._backfill_step,
                               *a, **kw)

        def _wide_slice(self, *a, **kw):
            return self._timed("_wide_slice", super()._wide_slice, *a, **kw)

        def _young_slice(self, *a, **kw):
            return self._timed("_young_slice", super()._young_slice, *a,
                               **kw)

        def warmup(self, *a, **kw):
            t = time.perf_counter()
            super().warmup(*a, **kw)
            torch.cuda.synchronize()
            warm["first_s"] = time.perf_counter() - t
            sig["loop"].call_soon_threadsafe(sig["q"].put_nowait, None)

        def track_monocular(self, gray, timestamp):
            out = super().track_monocular(gray, timestamp)
            sig["loop"].call_soon_threadsafe(sig["q"].put_nowait, out)
            return out

    packets, arrivals, waiters, lat = [], {}, [], []
    tum = tempfile.NamedTemporaryFile(suffix=".txt", delete=False).name
    atexit.register(lambda: os.path.exists(tum) and os.unlink(tum))

    async def session():
        sig["loop"], sig["q"] = asyncio.get_running_loop(), asyncio.Queue()

        async def host(reader, writer):
            async def read_poses():
                dec = PacketDecoder()
                while data := await reader.read(1 << 16):
                    now = time.perf_counter()
                    for p in dec.feed(data):
                        packets.append(p)
                        arrivals.setdefault(p["timestamp"], now)
                    for w in waiters:
                        w.set()
                    waiters.clear()

            async def signal():
                """The backend's next signal, or its failure."""
                get = asyncio.ensure_future(sig["q"].get())
                await asyncio.wait({get, client_task},
                                   return_when=asyncio.FIRST_COMPLETED)
                if not get.done():
                    get.cancel()
                    client_task.result()
                    raise RuntimeError("the backend ended early")
                return get.result()

            async def arrival(key):
                while key not in arrivals:
                    w = asyncio.Event()
                    waiters.append(w)
                    await asyncio.wait_for(w.wait(), 30)
                return arrivals[key]

            reading = asyncio.create_task(read_poses())
            writer.write(calib)
            await writer.drain()
            await signal()                      # the warmup's end
            for k in range(n):
                t_send = time.perf_counter()
                writer.write(wire[k])
                await writer.drain()
                out = await signal()
                if out.tracking_state == TRACKING_OK:
                    lat.append((await arrival(float(ts[k])) - t_send) * 1e3)
            writer.write(frame_packet_bytes(build_terminate_packet()))
            await writer.drain()
            await reading
            writer.close()

        server = await asyncio.start_server(host, "127.0.0.1", 0)
        client = bc.BackendClient("127.0.0.1",
                                  server.sockets[0].getsockname()[1],
                                  device="cuda")
        client.trajectory_path = tum
        client_task = asyncio.create_task(client.run())
        await client_task
        server.close()
        await server.wait_closed()
        return client

    printed = io.StringIO()
    bc.System = Served
    fast_cuda.launches = 0
    try:
        with contextlib.redirect_stdout(printed):
            client = asyncio.run(asyncio.wait_for(session(), 200))
    finally:
        bc.System = System
    launches = fast_cuda.launches
    system = client.system
    torch.cuda.synchronize()
    fast_cuda.launches = 0
    t = time.perf_counter()
    System(flagship_config(), device="cuda").warmup()
    torch.cuda.synchronize()
    warm_second_s = time.perf_counter() - t
    warm_launches = fast_cuda.launches      # the warmup's make_frame calls

    want = run["wire"]
    got = [(p["timestamp"], [p["position"][c] for c in "xyz"],
            [p["orientation"][c] for c in "xyzw"]) for p in packets]
    same = (len(got) == len(want) and all(
        a[0] == b[0] and np.array_equal(np.asarray(a[1]), np.asarray(
            b[1], np.float64)) and np.array_equal(
            np.asarray(a[2]), np.asarray(b[2], np.float64))
        for a, b in zip(got, want)))
    diff = next(({"index": i, "timestamps": [a[0], b[0]],
                  "max_abs_diff": _max_err(a[1], b[1])}
                 for i, (a, b) in enumerate(zip(got, want))
                 if a[0] != b[0] or not np.array_equal(
                     np.asarray(a[1]), np.asarray(b[1], np.float64))), None)
    kf_valid = int(system.map.kf_valid[:int(system.map.n_kf)].sum())
    with open(tum) as f:
        tum_lines = [ln for ln in f.read().splitlines() if ln.strip()]
    report = dict(re.findall(r"^([A-Za-z ]+): (\S+)$", printed.getvalue(),
                             re.M))
    # Phase 6, the same-seed replay, is this run: the served System's
    # whole trajectory (the shutdown drain included), keyframes,
    # landmarks and polish slices against phase 5's.
    traj, main_traj = system.trajectory(), run["trajectory"]
    rdiff = next(({"index": i, "timestamps": [a[0], b[0]],
                   "max_abs_diff": _max_err(a[1], b[1])}
                  for i, (a, b) in enumerate(zip(main_traj, traj))
                  if a[0] != b[0] or not np.array_equal(a[1], b[1])
                  or not np.array_equal(a[2], b[2])), None)
    replay_same = (len(traj) == len(main_traj) and rdiff is None
                   and system._n_kf_host == run["keyframes"]
                   and int(system.map.n_landmarks()) == run["landmarks"]
                   and system.polish_slices_run == run["polish_slices"])
    emit(dict(phase="replay", through="server_path", frames=n,
              first_difference=rdiff, poses=len(traj),
              first_run_poses=len(main_traj),
              keyframes=system._n_kf_host,
              landmarks=int(system.map.n_landmarks()),
              first_run_landmarks=run["landmarks"],
              polish_slices=dict(system.polish_slices_run),
              bit_equal=replay_same, ms_per_call=step_ms))
    if not replay_same:
        fail("server_path: the served session is not a bit-equal replay of "
             "the main path")
    res = dict(
        phase="server_path", frames=n, pose_packets=len(got),
        expected_packets=len(want),
        main_path_poses=run["live"] + run["backfilled"],
        bit_equal=same, first_difference=diff,
        all_ok=all(p["type"] == "pose" and p["tracking_state"] == TRACKING_OK
                   and p["camera_id"] == 0 for p in packets),
        decode_exact=decode_exact, native_library=native.available(),
        tum_lines=len(tum_lines), final_keyframes=kf_valid,
        shutdown_report=report, warmup_first_s=warm.get("first_s"),
        warmup_second_s=warm_second_s, kernel_build_s=kernel_build_s,
        median_ms_packet_to_pose=(statistics.median(lat[1:])
                                  if len(lat) > 1 else None),
        main_path_median_ms_per_tracked_frame=(
            statistics.median(run["t_ok"][1:]) if len(run["t_ok"]) > 1
            else None),
        mean_ms_packet_to_pose=(statistics.fmean(lat[1:])
                                if len(lat) > 1 else None),
        frame_packet_bytes=len(wire[0]),
        pose_packet_bytes=len(frame_packet_bytes(packets[0]))
        if packets else None,
        fast_launches=launches, warmup_launches=warm_launches,
        frames_through_make_frame=system.frames_extracted, **host)
    emit(res)
    if not same:
        fail(f"server_path: the backend's {len(got)} pose packets differ "
             f"from the main path's {len(want)} ({diff})")
    if not (res["all_ok"] and decode_exact and res["native_library"]):
        fail("server_path: a pose packet is not an OK pose of camera 0, "
             "or the PPM decode is not exact, or the native library did "
             "not load")
    if len(tum_lines) != kf_valid or kf_valid < 2 \
            or any(len(ln.split()) != 8 for ln in tum_lines):
        fail(f"server_path: {len(tum_lines)} TUM lines for {kf_valid} "
             "keyframes")
    if report.get("Frames processed") != str(n):
        fail(f"server_path: shutdown report {report}")
    if launches != system.frames_extracted + warm_launches \
            or warm_launches < 1:
        fail(f"server_path: {launches} FAST launches for "
             f"{system.frames_extracted} frames and a warmup of "
             f"{warm_launches}")
    return res


def app_path(torch, fast_cuda, frames, warm_launches):
    """Phase 5b: ``Application`` on the card over the first APP_FRAMES
    frames written as P6, ports 0: the engine, the :tcp listener and the
    web panel. This script's own WebSocket client reads ``/client``
    until an OK pose, ``/metrics`` and ``/`` are fetched, and a raw TCP
    probe decodes a ``frame`` packet."""
    from send_slam_tpu_torch.config import ServerConfig
    from send_slam_tpu_torch.io.ppm import decode_ppm, encode_ppm
    from send_slam_tpu_torch.io.protocol import PacketDecoder
    from send_slam_tpu_torch.server import bus as topics
    from send_slam_tpu_torch.server.app import Application
    os.environ.pop("SLAM_SKIP_WARMUP", None)
    seq = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    atexit.register(shutil.rmtree, seq, ignore_errors=True)
    for k in range(APP_FRAMES):
        with open(os.path.join(seq, f"{k:06d}.ppm"), "wb") as f:
            f.write(encode_ppm(np.repeat(frames[k][..., None], 3, axis=2)))
    base = flagship_config()
    cfg = base.replace(
        camera=dataclasses.replace(base.camera, fps=APP_FPS),
        server=ServerConfig(http_port=0, tcp_port=0))
    count = dict(published=0, before_engine=0, dropped=0)
    published, engine_q, live_ts, last = {}, [], set(), [None]

    async def go():
        app = Application(config=cfg, video=os.path.join(seq, "%06d.ppm"),
                          run_engine=True, run_tcp=True, run_web=True,
                          device="cuda")
        publish = app.bus.publish

        def counted(topic, msg):
            if topic == topics.CAMERA:
                subs = app.bus._subs.get(topics.CAMERA, ())
                if not engine_q and len(subs) == 1:
                    engine_q.extend(subs)       # the engine's queue
                count["published"] += 1
                published[msg.timestamp] = msg.frame
                if not engine_q:
                    count["before_engine"] += 1
                elif engine_q[0].full():
                    count["dropped"] += 1
            elif topic == topics.POSE and msg["timestamp"] == last[0]:
                live_ts.add(msg["timestamp"])   # not a late (backfill) pose
            publish(topic, msg)

        app.bus.publish = counted
        await app.start()
        track = app.engine.system.track_monocular

        def tracked(gray, timestamp):
            out = track(gray, timestamp)
            last[0] = timestamp
            return out

        app.engine.system.track_monocular = tracked
        try:
            port = app.web.bound_port
            ws = await WsClient.connect(port, "/client")
            lat, late, ok = [], 0, 0
            while len(lat) < APP_POSES:
                d = json.loads(await asyncio.wait_for(ws.recv_text(), 120))
                ok += d["payload"]["tracking_state"] == 2
                if d["payload"]["timestamp"] in live_ts:
                    lat.append((time.time() - d["payload"]["timestamp"])
                               * 1e3)
                else:
                    late += 1
            await ws.close()
            for _ in range(100):
                status, body = await http_get(port, "/metrics")
                metrics = json.loads(body)
                if metrics.get("n_keyframes", 0) >= 2:
                    break
                await asyncio.sleep(0.1)
            index_status, index = await http_get(port, "/")
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", app.tcp.bound_port)
            dec, pkt = PacketDecoder(), None
            while pkt is None:
                data = await asyncio.wait_for(reader.read(1 << 20), 30)
                if not data:
                    raise ConnectionError("the :tcp listener hung up")
                pkt = next((p for p in dec.feed(data)
                            if p.get("type") == "frame"), None)
            writer.close()
            app.engine.stop()                   # between two frames
            await asyncio.wait_for(app._tasks[0], 60)
        finally:
            await app.stop()
        return app, lat, late, ok, metrics, status, index_status, index, pkt

    fast_cuda.launches = 0
    t0 = time.perf_counter()
    app, lat, late, ok, metrics, status, index_status, index, pkt = \
        asyncio.run(asyncio.wait_for(go(), 180))
    launches = fast_cuda.launches
    system = app.engine.system
    img = decode_ppm(pkt["frame"])
    probe_equal = np.array_equal(img, published.get(pkt["timestamp"]))
    probe_source = any(np.array_equal(img, np.repeat(f[..., None], 3, 2))
                       for f in frames[:APP_FRAMES])
    res = dict(
        phase="app_path", frames_written=APP_FRAMES, fps=APP_FPS,
        frames_published=count["published"],
        published_before_engine=count["before_engine"],
        dropped_by_bus=count["dropped"], frames_in=app.engine.frames_in,
        frames_tracked=app.engine.frames_tracked,
        live_poses_seen=len(lat), late_poses_seen=late, ok_poses_seen=ok,
        client_latency_ms=lat,
        client_latency_ms_median=statistics.median(lat),
        metrics_status=status, metrics_frames=metrics.get("frames"),
        metrics_n_keyframes=metrics.get("n_keyframes"),
        index_status=index_status, index_bytes=len(index),
        tcp_probe_equal=probe_equal, tcp_probe_source_frame=probe_source,
        fast_launches=launches,
        frames_through_make_frame=system.frames_extracted,
        seconds=time.perf_counter() - t0)
    emit(res)
    if ok != len(lat) + late:
        fail(f"app_path: {len(lat) + late - ok} poses on /client not OK")
    if not (status == 200 and metrics.get("frames", 0) > 0
            and metrics.get("n_keyframes", 0) >= 2):
        fail(f"app_path: /metrics answered {status} {metrics}")
    if index_status != 200 or b"SEND-SLAM" not in index:
        fail(f"app_path: GET / answered {index_status}")
    if not (probe_equal and probe_source):
        fail("app_path: the :tcp frame packet is not the producer's frame")
    if launches != system.frames_extracted + warm_launches \
            or system.frames_extracted < 1:
        fail(f"app_path: {launches} FAST launches for "
             f"{system.frames_extracted} frames and a warmup of "
             f"{warm_launches}")
    return res


def main() -> int:
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.models.frame import make_frame
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    from send_slam_tpu_torch.models.system import (
        TRACKING_OK, System, loop_state_to_numpy,
    )
    from send_slam_tpu_torch.ops import fast as fast_ops
    from send_slam_tpu_torch.ops import fast_cuda
    from send_slam_tpu_torch.ops.pyramid import build_pyramid, level_shapes
    from send_slam_tpu_torch.utils.synth import SyntheticWorld

    # --- 1. environment + build -------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else "nvidia-smi: no output"
    print(smi, flush=True)
    t0 = time.perf_counter()
    fast_cuda.load()
    build_s = time.perf_counter() - t0
    emit(dict(phase="environment", device=name, nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              kernel_library=str(fast_cuda.library_path().name),
              kernel_build_s=build_s, nvcc_s=fast_cuda.build_seconds,
              ptxas=ptxas_summary(fast_cuda.ptxas_report())))

    # --- 2 + 3. kernel vs plain on the card, and its times -----------------
    kc = kernel_check(torch, fast_cuda, fast_ops, level_shapes)
    emit(dict(phase="kernel_check", **kc))
    cfg = flagship_config()
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=N_FRAMES)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(N_FRAMES)]
    bench_pyr = build_pyramid(
        torch.from_numpy(frames[N_FRAMES // 2].astype(np.float32)).cuda(),
        cfg.orb.n_levels, cfg.orb.scale_factor)
    kt = kernel_times(torch, fast_cuda, fast_ops, level_shapes, bench_pyr)
    emit(dict(phase="kernel_times", device=name, nvidia_smi=smi, **kt))

    # --- 4 + 5. front end and main path at the flagship config -------------
    emit(dict(phase="frontend_check",
              **frontend_check(torch, make_frame, cfg, frames[0])))

    snaps = []

    def snapshot(k, s):
        """The carried state after the first tracked frame at or past
        each of PARITY_FRAMES (with 3 keyframes and a next frame); taken
        after the frame's timing."""
        if len(snaps) < len(PARITY_FRAMES) \
                and k >= PARITY_FRAMES[len(snaps)] and k + 1 < len(frames) \
                and s.state == TRACKING_OK and int(s.map.n_kf) >= 3:
            snaps.append(dict(k=k, map=map_to_numpy(s.map),
                              st=loop_state_to_numpy(s._st), t0=s._t0))

    system = System(cfg, device="cuda")
    system.frames_extracted = 0
    with keep_ba_inputs(torch, system) as kept_ba:
        fast_cuda.launches = 0
        run = drive(torch, system, frames, ts, after_frame=snapshot)
        launches = fast_cuda.launches
    run["trajectory"] = system.trajectory()
    n_extracted = system.frames_extracted

    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])
    est_ts, pos = run["est_ts"], run["est_pos"]
    tracked = len(est_ts)
    ate = ate_rmse(est_ts, pos, ts, gt) if tracked >= 3 else float("inf")
    result = dict(
        phase="main_path", device=name, nvidia_smi=smi,
        config="EngineConfig(camera=...): the JAX package's defaults, "
               "loop closing on",
        frames=N_FRAMES, tracked=tracked, tracked_live=run["live"],
        backfilled=run["backfilled"], tracked_unique=len(set(est_ts)),
        init_commit_ts=system.init_commit_ts,
        collapse_resets=sum(not p[3] for p in system.collapse_probes),
        collapse_probes=system.collapse_probes,
        polish_slices=dict(system.polish_slices_run),
        keyframes=int(system._n_kf_host),
        landmarks=int(system.map.n_landmarks()),
        ate_m=ate, frames_through_make_frame=n_extracted,
        fast_launches=launches,
        median_ms_per_tracked_frame=(statistics.median(run["t_ok"][1:])
                                     if len(run["t_ok"]) > 1 else None),
        mean_ms_per_tracked_frame=(statistics.fmean(run["t_ok"][1:])
                                   if len(run["t_ok"]) > 1 else None),
        seconds=run["seconds"])
    emit(result)
    if system.init_commit_ts is None:
        fail("the system never initialized")
    if tracked < MIN_TRACKED:
        fail(f"tracked {tracked} of {N_FRAMES} frames (< {MIN_TRACKED})")
    if not (np.isfinite(pos).all() and np.isfinite(ate)):
        fail("non-finite trajectory or ATE")
    if launches != n_extracted or launches == 0:
        fail(f"{launches} FAST launches for {n_extracted} frames "
             "(expected one per make_frame)")

    # --- 5a (and 6) + 5b. the server entry points at the flagship config --
    served = server_path(torch, System, fast_cuda, frames, ts, run, build_s)
    app_run = app_path(torch, fast_cuda, frames, served["warmup_launches"])

    # --- 12 + 13 start: the long and atlas sessions in a second process,
    # beside phases 7-11 (their frames are host-bound, as the main
    # path's are, and the card has room for both).
    # The two flagship lanes (15, 16) in a third process and the 8-lane
    # ring (17) in a fourth, beside both.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    atexit.register(_stop_children)       # a failed check exits early
    child = start_child("--sessions", tmp)
    lanes_child = start_child("--lanes", tmp)
    ring_child = start_child("--ring", tmp)
    offline_child = start_child("--offline", tmp)

    # --- 7. the carried state of phase 5 held card vs CPU -----------------
    if len(snaps) < len(PARITY_FRAMES):
        fail(f"only {len(snaps)} carried states were taken at or past the "
             f"main path's frames {PARITY_FRAMES}: no step parity")
    emit(dict(phase="step_parity",
              **step_parity(torch, System, cfg, snaps, frames, ts,
                            kept_ba)))

    # --- 8. relocalization on the main run's System -----------------------
    reloc_ms = time_calls(torch, system, ("_reloc_step",))
    emit(dict(phase="relocalization", reloc_step_ms=reloc_ms["_reloc_step"],
              **reloc_phase(system, frames, ts, gt, est_ts, pos)))

    # --- 9. map I/O of the main run's final map ---------------------------
    map_io_phase(torch, System, cfg, system, frames, ts)

    # --- 10 + 11. the loop session, its programs card vs CPU --------------
    lp, kept = loop_path(torch, System, cfg, fast_cuda)
    loop_parity(torch, System, cfg, kept)

    # --- 12-14. compaction, the atlas, their programs card vs CPU ---------
    ls, ap, sp, kept = join_sessions(torch, child, tmp)
    long_parity(torch, System, kept, cfg)

    # --- 15-17. the camera lanes, their parity and the 8-lane ring -------
    lanes = join_child(lanes_child, tmp, "lanes", "the camera lanes")
    lanes.update(join_child(ring_child, tmp, "ring", "the 8-lane ring"))

    # --- 18-21. offline evaluation: the datasets, the example, texture ----
    offline = join_child(offline_child, tmp, "offline",
                         "the offline-evaluation phases")
    offline_vs_main(run, result, offline, os.path.join(tmp, "offline.npz"))

    emit({"kernels": [{
        "name": "fast_score", "route": "cuda",
        "source": "send_slam_tpu_torch/csrc/fast_kernel.cu",
        "replaces": "send_slam_tpu/ops/pallas/fast_kernel.py:226",
        "launches": launches,
        "server_path_launches": served["fast_launches"],
        "app_path_launches": app_run["fast_launches"],
        "loop_path_launches": lp["fast_launches"],
        "long_session_launches": ls["fast_launches"],
        "atlas_path_launches": ap["fast_launches"],
        "scale_path_launches": sp["fast_launches"],
        "scale_path_make_frame_calls": sp["frames_through_make_frame"],
        "dataset_tum_launches": offline["dataset_tum"]["fast_launches"],
        "dataset_euroc_launches": offline["dataset_euroc"]["fast_launches"],
        "dataset_euroc_launches_held_against_plain":
            offline["dataset_euroc"]["launches_held_against_plain"],
        "textured_path_launches": offline["textured_path"]["fast_launches"],
        "max_abs_err": max(kc["max_abs_err"],
                           offline["dataset_euroc"]["held_max_abs_err"]),
        "max_abs_diff": max(kc["max_abs_err"],
                            offline["dataset_euroc"]["held_max_abs_err"]),
        "ms": kt["ms"], "launch_interval_ms": kt["launch_interval_ms"],
        "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
        "library_ms": None, "unit": kt["unit"],
        "scale_1_3": {k: kt["scale_1_3"][k] for k in (
            "levels", "ms", "plain_ms", "bound_ms", "bound_by")},
        "euroc_752x480": {k: kt["euroc_752x480"][k] for k in (
            "levels", "ms", "plain_ms", "bound_ms", "bound_by")}}, {
        "name": "fast_score_batched", "route": "cuda",
        "source": "send_slam_tpu_torch/csrc/fast_kernel.cu",
        "replaces": "send_slam_tpu/ops/pallas/fast_kernel.py:198",
        "launches": lanes["lanes_path"]["fast_launches"],
        "lanes_ring_launches": lanes["lanes_ring"]["fast_launches"],
        "launches_held_against_plain": [
            lanes["lanes_path"]["launches_held_against_plain"],
            lanes["lanes_ring"]["launches_held_against_plain"]],
        "max_abs_err": max(kc["lanes_max_abs_err"],
                           lanes["lanes_path"]["held_max_abs_err"],
                           lanes["lanes_ring"]["held_max_abs_err"]),
        "ms": kt["pair"]["ms"], "plain_ms": kt["pair"]["plain_ms"],
        "bound_ms": kt["pair"]["bound_ms"],
        "bound_by": kt["pair"]["bound_by"], "library_ms": None,
        "unit": "per step of 2 lanes: 2 x 8 pyramid levels of 640x480, "
                "raw + NMS at th 7 (lanes_path's launch)",
        "eight_lanes": {k: kt["batch"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}}]})
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sessions":
        sys.exit(sessions_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] in ("--lanes", "--ring"):
        sys.exit(lanes_main(sys.argv[2], ring=sys.argv[1] == "--ring"))
    if len(sys.argv) == 3 and sys.argv[1] == "--offline":
        sys.exit(offline_main(sys.argv[2]))
    sys.exit(main())
