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
   BA window 8) with the JAX package's default tracking options and
   loop closing off (slice_config) over 90 frames of the synthetic bench
   scene, with the kernel's launch count read around the run (one
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

then the kernels summary line and, last, {"ok": true, "device": ...}.
Any failed check exits non-zero; a watchdog ends the run after 290 s.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time

import numpy as np

WATCHDOG_S = 290
N_FRAMES = 90
MIN_TRACKED = 30
PARITY_FRAMES = (30, 55, 80)    # replay frames whose carried state is held
RELOC_FRAMES = 5                # mapped frames allowed to relocalize
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


def _watchdog(signum, frame):
    print(f"chip_smoke: watchdog fired after {WATCHDOG_S} s", file=sys.stderr,
          flush=True)
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


def drive(torch, system, frames, ts, after_frame=None):
    """Feed the frames and drain at shutdown; count poses as bench.py
    does (live OK outputs, backfill triples, the shutdown drain).
    Returns the emitted (timestamp, position, orientation) list in
    emission order, the time-ordered estimate and the per-frame ms of
    live OK frames (each frame ends in a device sync)."""
    from send_slam_tpu_torch.models.system import TRACKING_OK
    emitted, t_ok, live, backfilled = [], [], 0, 0
    t_run = time.perf_counter()

    def take(out):
        nonlocal live, backfilled
        if out.tracking_state == TRACKING_OK:
            live += 1
            emitted.append((out.timestamp, out.position, out.orientation))
        backfilled += len(out.backfill)
        emitted.extend(out.backfill)

    for k in range(len(frames)):
        t0 = time.perf_counter()
        out = system.track_monocular(frames[k], float(ts[k]))
        torch.cuda.synchronize()
        if out.tracking_state == TRACKING_OK:
            t_ok.append((time.perf_counter() - t0) * 1e3)
        take(out)
        if after_frame is not None:
            after_frame(k, system)
    for out in system.shutdown():
        take(out)
    torch.cuda.synchronize()
    order = np.argsort(np.asarray([e[0] for e in emitted]), kind="stable")
    return dict(emitted=emitted, live=live, backfilled=backfilled, t_ok=t_ok,
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
    from send_slam_tpu_torch.config import (
        CameraConfig, EngineConfig,
    )
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.models.frame import make_frame
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    from send_slam_tpu_torch.models.system import (
        TRACKING_OK, System, loop_state_to_numpy, slice_config,
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
    cfg = slice_config(EngineConfig(camera=CameraConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0)))
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
        config="slice_config(EngineConfig(camera=...)): default tracking, "
               "loop closing off",
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

    emit({"kernels": [{
        "name": "fast_score", "route": "cuda",
        "source": "send_slam_tpu_torch/csrc/fast_kernel.cu",
        "replaces": "send_slam_tpu/ops/pallas/fast_kernel.py:226",
        "launches": launches, "max_abs_err": kc["max_abs_err"],
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
    sys.exit(main())
