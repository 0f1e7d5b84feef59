#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (send_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, printing no result).
Phases, each printing one JSON line:

1. environment: the card, its power limit (nvidia-smi), the nvcc build
   of the CUDA FAST kernel from send_slam_tpu_torch/csrc/;
2. kernel_check: the FAST kernel held against its plain PyTorch version
   on the card (all 8 pyramid-level shapes of a 640x480 frame, a ragged
   100x128 image and a batch of 3; thresholds 7 and 20; raw and NMS
   maps), with kernel, plain and bound times;
3. frontend_check: make_frame on the card against make_frame on the CPU
   (the plain path) on one 640x480 frame;
4. main_path: System.track_monocular at the flagship configuration
   (640x480, 1250 features, 8 levels, 256 keyframes, 16384 landmarks,
   BA window 8) over 90 frames of the synthetic bench scene, with the
   kernel's launch count read around the run;

then the kernels summary line and, last, {"ok": true, "device": ...}.
Any failed check exits non-zero; a watchdog ends the run after 290 s.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import time

import numpy as np

WATCHDOG_S = 290
N_FRAMES = 90
MIN_TRACKED = 30
TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 non-tensor.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# Operations per pixel of the FAST kernel with fused NMS, counted from
# csrc/fast_kernel.cu (16 subtractions, 64 mask compares/ors, 22 run-test
# ops, 304 arc mins/maxes/negations, 16 NMS compares, 2 selects).
FAST_OPS_PER_PIXEL = 424
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


def kernel_check(torch, fast_cuda, fast_ops, level_shapes):
    """Phase 2: the CUDA kernel against the plain version on the card."""
    dev = torch.device("cuda")
    shapes = list(level_shapes(480, 640, 8, 1.2))
    max_err = 0.0
    cases = 0
    for i, (h, w) in enumerate(shapes + [(100, 128)]):
        img = torch.from_numpy(texture(h, w, seed=i)).to(dev)
        for th in (7.0, 20.0):
            raw, nms = fast_cuda.fast_score_cuda(img, th, with_nms=True)
            raw_only = fast_cuda.fast_score_cuda(img, th)
            ref = fast_ops.fast_score_map(img, th)
            ref_nms = fast_ops.nms3x3(ref)
            torch.cuda.synchronize()
            err = max(float((raw - ref).abs().max()),
                      float((nms - ref_nms).abs().max()),
                      float((raw_only - ref).abs().max()))
            if not err <= TOL:
                fail(f"FAST kernel disagrees at {h}x{w} th={th}: {err}")
            if int((ref_nms > 0).sum()) == 0:
                fail(f"texture {h}x{w} th={th} has no corners to check")
            max_err = max(max_err, err)
            cases += 1
    for (h, w) in ((225, 300), (100, 128)):
        batch = torch.stack([torch.from_numpy(texture(h, w, seed=50 + s))
                             for s in range(3)]).to(dev)
        for th in (7.0, 20.0):
            raw_b, nms_b = fast_cuda.fast_score_cuda(batch, th, with_nms=True)
            for r in range(3):
                raw_1, nms_1 = fast_cuda.fast_score_cuda(
                    batch[r].contiguous(), th, with_nms=True)
                if not (torch.equal(raw_b[r], raw_1)
                        and torch.equal(nms_b[r], nms_1)):
                    fail(f"batch row {r} ({h}x{w}) differs from its "
                         "single-image launch")
                ref = fast_ops.fast_score_map(batch[r], th)
                err = max(float((raw_b[r] - ref).abs().max()),
                          float((nms_b[r] - fast_ops.nms3x3(ref)).abs().max()))
                if not err <= TOL:
                    fail(f"batched FAST disagrees ({h}x{w} row {r}): {err}")
                max_err = max(max_err, err)
            cases += 1

    # Times at the main path's shapes: one launch per level, raw + NMS
    # at min_th_fast = 7, summed over the 8 levels of a frame.
    per_level = []
    for i, (h, w) in enumerate(shapes):
        img = torch.from_numpy(texture(h, w, seed=i)).to(dev)
        def kernel():
            fast_cuda.fast_score_cuda(img, 7.0, with_nms=True)

        ms = cuda_ms(kernel, 50)
        launch_ms = cuda_ms(kernel, 50, queued=False)
        plain_ms = cuda_ms(lambda: fast_ops.nms3x3(
            fast_ops.fast_score_map(img, 7.0)), 5, repeats=3)
        n_px = h * w
        bytes_moved = 3 * 4 * n_px              # read img, write raw + nms
        ops = FAST_OPS_PER_PIXEL * n_px
        per_level.append(dict(shape=[h, w], ms=ms, launch_interval_ms=launch_ms,
                              plain_ms=plain_ms, bytes=bytes_moved, ops=ops))
    frame_bytes = sum(p["bytes"] for p in per_level)
    frame_ops = sum(p["ops"] for p in per_level)
    t_bytes = frame_bytes / PEAK_BYTES_S * 1e3
    t_ops = frame_ops / PEAK_FP32_S * 1e3
    return dict(cases=cases, max_abs_err=max_err, per_level=per_level,
                ms=sum(p["ms"] for p in per_level),
                launch_interval_ms=sum(p["launch_interval_ms"]
                                       for p in per_level),
                plain_ms=sum(p["plain_ms"] for p in per_level),
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                frame_bytes=frame_bytes, frame_ops=frame_ops)


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
    from send_slam_tpu_torch.ops.pyramid import level_shapes
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
              kernel_build_s=build_s, nvcc_s=fast_cuda.build_seconds))

    # --- 2. kernel vs plain on the card ------------------------------------
    kc = kernel_check(torch, fast_cuda, fast_ops, level_shapes)
    emit(dict(phase="kernel_check", **kc))

    # --- 3 + 4. front end and main path at the flagship config -------------
    cfg = slice_config(EngineConfig(camera=CameraConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0)))
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=N_FRAMES)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(N_FRAMES)]
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
    n_levels = cfg.orb.n_levels

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
    if launches != n_levels * n_extracted or launches == 0:
        fail(f"{launches} FAST launches for {n_extracted} frames "
             f"(expected {n_levels} per frame)")

    emit({"kernels": [{
        "name": "fast_score", "route": "cuda",
        "source": "send_slam_tpu_torch/csrc/fast_kernel.cu",
        "replaces": "send_slam_tpu/ops/pallas/fast_kernel.py:226",
        "launches": launches, "max_abs_err": kc["max_abs_err"],
        "max_abs_diff": kc["max_abs_err"],
        "ms": kc["ms"], "launch_interval_ms": kc["launch_interval_ms"],
        "plain_ms": kc["plain_ms"],
        "bound_ms": kc["bound_ms"], "bound_by": kc["bound_by"],
        "library_ms": None,
        "unit": "per 640x480 frame: 8 pyramid levels, raw + NMS at th 7"}]})
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
