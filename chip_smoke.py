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
   raw and NMS maps), then one launch over the whole 8-level pyramid and
   one over a batch of 8 such pyramids;
3. kernel_times: per 640x480 frame, one launch over the 8 levels (device
   time queued behind a spin kernel, and the unqueued launch interval),
   8 one-level launches of the same kernel (both times), the plain
   version, the batch of 8 pyramids, and the bytes and operations
   bounds (the operations counted on the timed inputs);
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
6. replay: the same run on a fresh System in the same process; every
   emitted pose, the keyframe and the landmark counts must be
   bit-equal to the first run's;
7. step_parity: at 3 tracked frames of the replay, the carried map and
   loop state go to a card System and a CPU System, and each runs
   _frame_step on the next image, one wide and one young polish slice,
   and _reloc_step on an earlier image with the same injected RANSAC
   draws; poses to 1e-4, inliers +-2, the keyframe decision, keyframe
   count, rebase flag and winning branch exactly, polished poses and
   landmarks to 1e-3;
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

Phases 12 and 13 run in a second process (``chip_smoke.py --sessions
DIR``), started after phase 5 and running beside phases 6-11, so the
times of phases 6-13 are taken beside the other process (run
``--sessions DIR`` alone for phases 12 and 13 by themselves); their
lines are printed after phase 11's. Then the kernels summary line and, last, {"ok": true, "device":
...}.
Any failed check exits non-zero; a watchdog ends the run after 290 s.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import dataclasses
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

WATCHDOG_S = 290
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
    for child in _CHILDREN:
        if child.poll() is None:
            child.kill()
            child.wait()


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
    torch.cuda.synchronize()
    return dict(cases=cases, comparison="torch.equal", max_abs_err=max_err)


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
    return dict(
        unit="per 640x480 frame: 8 pyramid levels, raw + NMS at th 7",
        tile=[fast_cuda.TILE_W, fast_cuda.TILE_H],
        ms=ms, launch_interval_ms=launch_ms, launch_host_ms=launch_host_ms,
        eight_launches_ms=eight_ms,
        eight_launches_interval_ms=eight_launch_ms,
        plain_ms=plain_ms, **bound, old_ops_bound_ms=old_ops_bound_ms,
        bench_scene=dict(ms=bench_ms, **bench_bound),
        batch=dict(lanes=8, levels=8, ms=batch_ms, **batch_bound))


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
    estimate, each frame's tracking state and the per-frame ms of live
    OK frames (each frame ends in a device sync)."""
    from send_slam_tpu_torch.models.system import TRACKING_OK
    emitted, t_ok, live, backfilled, states = [], [], 0, 0, []
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
                states=states,
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


def step_parity(torch, System, cfg, snaps, frames, ts):
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
    return dict(tolerances=dict(pose=1e-4, inliers=2, polish=1e-3),
                worst=worst, checks=checks, card_ms_per_call=card_ms)


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
    after the main path so that they run beside phases 6-11: their JSON
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
    kept_atlas.pop("sim3_failed")
    torch.save(_pack(dict(kept_long, **kept_atlas)),
               os.path.join(outdir, "kept.pt"))
    return 0


def join_sessions(torch, child, outdir):
    """Wait for the sessions process, re-emit its lines, and return
    (long_session's result, atlas_path's result, the kept inputs on the
    card)."""
    rc = child.wait()
    with open(os.path.join(outdir, "sessions.out")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for ln in lines:
        print(ln, flush=True)
    if rc != 0:
        with open(os.path.join(outdir, "sessions.err")) as f:
            err = f.read()[-3000:]
        fail(f"the long and atlas sessions exited with {rc}:\n{err}")
    phases = {}
    for ln in lines:
        if ln.startswith("{"):
            obj = json.loads(ln)
            phases[obj.get("phase")] = obj
    kept = _unpack(torch.load(os.path.join(outdir, "kept.pt"),
                              weights_only=True), "cuda")
    return phases["long_session"], phases["atlas_path"], kept


def _fields_close(a, b, rel):
    """Integer and boolean fields of two maps equal, float fields within
    ``rel`` of the field's largest magnitude. Returns (equal, worst)."""
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    a, b = map_to_numpy(a), map_to_numpy(b)
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

    fast_cuda.launches = 0
    system = System(cfg, device="cuda")
    system.frames_extracted = 0
    run = drive(torch, system, frames, ts)
    launches = fast_cuda.launches
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

    # --- 12 + 13 start: the long and atlas sessions in a second process,
    # beside phases 6-11 (their frames are host-bound, as the main
    # path's are, and the card has room for both).
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    atexit.register(_stop_children)       # a failed check exits early
    with open(os.path.join(tmp, "sessions.out"), "w") as out, \
            open(os.path.join(tmp, "sessions.err"), "w") as err:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sessions", tmp],
            stdout=out, stderr=err)
    _CHILDREN.append(child)

    # --- 6 + 7. replay on a fresh System, carried state held card vs CPU --
    snaps = []

    def snapshot(k, s):
        """The carried state after the first tracked frame at or past
        each of PARITY_FRAMES (with 3 keyframes and a next frame)."""
        if len(snaps) < len(PARITY_FRAMES) \
                and k >= PARITY_FRAMES[len(snaps)] and k + 1 < len(frames) \
                and s.state == TRACKING_OK and int(s.map.n_kf) >= 3:
            snaps.append(dict(k=k, map=map_to_numpy(s.map),
                              st=loop_state_to_numpy(s._st), t0=s._t0))

    replay_sys = System(cfg, device="cuda")
    step_ms = time_calls(torch, replay_sys, ("_backfill_step", "_wide_slice",
                                             "_young_slice"))
    rerun = drive(torch, replay_sys, frames, ts, after_frame=snapshot)
    same = (len(rerun["emitted"]) == len(run["emitted"])
            and all(a[0] == b[0] and np.array_equal(a[1], b[1])
                    and np.array_equal(a[2], b[2])
                    for a, b in zip(run["emitted"], rerun["emitted"]))
            and rerun["keyframes"] == run["keyframes"]
            and rerun["landmarks"] == run["landmarks"])
    diff = next(({"index": i, "timestamps": [a[0], b[0]],
                  "max_abs_diff": _max_err(a[1], b[1])}
                 for i, (a, b) in enumerate(zip(run["emitted"],
                                                rerun["emitted"]))
                 if a[0] != b[0] or not np.array_equal(a[1], b[1])
                 or not np.array_equal(a[2], b[2])), None)
    emit(dict(phase="replay", frames=N_FRAMES, first_difference=diff,
              poses=len(rerun["emitted"]), first_run_poses=len(run["emitted"]),
              keyframes=rerun["keyframes"], landmarks=rerun["landmarks"],
              first_run_landmarks=run["landmarks"],
              polish_slices=rerun["polish_slices"], bit_equal=same,
              ms_per_call={n: v for n, v in step_ms.items()},
              seconds=rerun["seconds"]))
    if not same:
        fail("a same-seed rerun of the main path is not bit-equal to the "
             "first run")
    if len(snaps) < len(PARITY_FRAMES):
        fail(f"only {len(snaps)} carried states were taken at or past the "
             f"replay frames {PARITY_FRAMES}: no step parity")
    emit(dict(phase="step_parity",
              **step_parity(torch, System, cfg, snaps, frames, ts)))

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
    ls, ap, kept = join_sessions(torch, child, tmp)
    long_parity(torch, System, kept, cfg)

    emit({"kernels": [{
        "name": "fast_score", "route": "cuda",
        "source": "send_slam_tpu_torch/csrc/fast_kernel.cu",
        "replaces": "send_slam_tpu/ops/pallas/fast_kernel.py:226",
        "launches": launches, "loop_path_launches": lp["fast_launches"],
        "long_session_launches": ls["fast_launches"],
        "atlas_path_launches": ap["fast_launches"],
        "max_abs_err": kc["max_abs_err"],
        "max_abs_diff": kc["max_abs_err"],
        "ms": kt["ms"], "launch_interval_ms": kt["launch_interval_ms"],
        "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
        "library_ms": None, "unit": kt["unit"]}]})
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sessions":
        sys.exit(sessions_main(sys.argv[2]))
    sys.exit(main())
