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
   BA window 8) over 90 frames of the synthetic bench scene, with the
   kernel's launch count read around the run (one launch per frame);

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
    from send_slam_tpu_torch.models.system import (
        TRACKING_OK, System, slice_config,
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

    system = System(cfg, device="cuda")
    fast_cuda.launches = 0
    system.frames_extracted = 0
    poses, t_ok = {}, []       # timestamp -> position of OK outputs
    for k in range(N_FRAMES):
        t0 = time.perf_counter()
        out = system.track_monocular(frames[k], float(ts[k]))
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        if out.tracking_state == TRACKING_OK:
            t_ok.append(dt_ms)
            poses.setdefault(out.timestamp, out.position)
    for out in system.shutdown():
        if out.tracking_state == TRACKING_OK:
            poses.setdefault(out.timestamp, out.position)
    torch.cuda.synchronize()
    launches = fast_cuda.launches
    n_extracted = system.frames_extracted

    est_ts = sorted(poses)
    tracked = len(est_ts)
    pos = np.asarray([poses[t] for t in est_ts], np.float64).reshape(-1, 3)
    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])
    ate = ate_rmse(est_ts, pos, ts, gt) if tracked >= 3 else float("inf")
    result = dict(
        phase="main_path", frames=N_FRAMES, tracked=tracked,
        init_commit_ts=system.init_commit_ts,
        keyframes=int(system._n_kf_host),
        landmarks=int(system.map.n_landmarks()),
        ate_m=ate, frames_through_make_frame=n_extracted,
        fast_launches=launches,
        median_ms_per_tracked_frame=(statistics.median(t_ok[1:])
                                     if len(t_ok) > 1 else None),
        mean_ms_per_tracked_frame=(statistics.fmean(t_ok[1:])
                                   if len(t_ok) > 1 else None))
    emit(result)
    if system.init_commit_ts is None:
        fail("the system never initialized")
    if tracked < MIN_TRACKED:
        fail(f"tracked {tracked} of {N_FRAMES} frames (< {MIN_TRACKED})")
    if not (np.isfinite(pos).all() and np.isfinite(ate)):
        fail("non-finite trajectory or ATE")
    if launches != n_extracted or launches == 0:
        fail(f"{launches} FAST launches for {n_extracted} frames "
             "(expected one per frame)")

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
