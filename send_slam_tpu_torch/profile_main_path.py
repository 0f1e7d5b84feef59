"""Where the port's main path spends its time on the card.

    python -m send_slam_tpu_torch.profile_main_path [--frames 90]

Runs ``System.track_monocular`` at the flagship configuration (640x480,
1250 features, 8 levels, 256 keyframes, 16384 landmarks, BA window 8)
over the synthetic bench scene three times and prints one JSON object:

- ``plain``: per-frame host wall time (each frame ends in a sync);
- ``phases``: the same run with each stage wrapped in synchronized
  timers (make_frame, track_frame, keyframe insertion, local BA, covis
  window, init, bootstrap, maintenance), summed over tracked frames;
- ``profile``: a torch.profiler window over frames 40-60: device busy
  time, busy share of the window, CUDA kernel launches per frame, host
  syncs, and the top kernels by device time.

Needs a CUDA card. Writes the profiler's kernel table to
``chiprun_out/profile_kernels.txt`` when that directory exists.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from send_slam_tpu_torch.config import CameraConfig, EngineConfig
from send_slam_tpu_torch.models import system as sysmod
from send_slam_tpu_torch.utils.synth import SyntheticWorld

PHASES = ("make_frame", "track_frame", "insert_keyframe_with_triangulation",
          "local_bundle_adjustment", "covis_window_ids", "two_view_init")


def _scene(n_frames):
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=n_frames)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(n_frames)]
    return ts, frames


def _run(cfg, ts, frames, on_frame=None):
    s = sysmod.System(cfg, device="cuda")
    times, ok = [], []
    for k in range(len(frames)):
        if on_frame is not None:
            on_frame(k)
        t0 = time.perf_counter()
        out = s.track_monocular(frames[k], float(ts[k]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ok.append(out.tracking_state == sysmod.TRACKING_OK)
    return s, times, ok


def _wrap(acc, name, fn):
    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[name] += (time.perf_counter() - t0) * 1e3
        return r
    return timed


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=90)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA card")
    cfg = EngineConfig(camera=CameraConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0))
    ts, frames = _scene(args.frames)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    _run(cfg, ts, frames[:12])                     # warm the allocator

    # 1. plain timing
    s, times, ok = _run(cfg, ts, frames)
    commit = next(i for i, o in enumerate(ok) if o)
    tracked_ms = [t for t, o in zip(times, ok) if o][1:]
    init_ms = times[:commit + 1]

    # 2. per-phase synchronized timers
    acc = collections.defaultdict(float)
    saved = {n: getattr(sysmod, n) for n in PHASES}
    saved_maint = sysmod.System._maintain_step
    saved_boot = sysmod.System._bootstrap_map
    for n in PHASES:
        setattr(sysmod, n, _wrap(acc, n, saved[n]))
    sysmod.System._maintain_step = _wrap(acc, "maintain_step", saved_maint)
    sysmod.System._bootstrap_map = _wrap(acc, "bootstrap_map", saved_boot)
    try:
        _, times2, ok2 = _run(cfg, ts, frames)
    finally:
        for n in PHASES:
            setattr(sysmod, n, saved[n])
        sysmod.System._maintain_step = saved_maint
        sysmod.System._bootstrap_map = saved_boot

    # 3. profiler window
    lo, hi = 40, min(60, args.frames)
    prof_holder = {}
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]

    def on_frame(k):
        if k == lo:
            p = torch.profiler.profile(activities=act)
            p.__enter__()
            prof_holder["p"] = p
            prof_holder["t0"] = time.perf_counter()
        if k == hi and "p" in prof_holder:
            torch.cuda.synchronize()
            prof_holder["wall"] = time.perf_counter() - prof_holder["t0"]
            prof_holder["p"].__exit__(None, None, None)

    _run(cfg, ts, frames, on_frame)
    if "wall" not in prof_holder:
        torch.cuda.synchronize()
        prof_holder["wall"] = time.perf_counter() - prof_holder["t0"]
        prof_holder["p"].__exit__(None, None, None)
    prof = prof_holder["p"]
    n_win = hi - lo
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    syncs = sum(1 for e in prof.events()
                if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaMemcpyAsync"))
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=40)
    if os.path.isdir("chiprun_out"):
        with open("chiprun_out/profile_kernels.txt", "w") as f:
            f.write(table)

    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        frames=args.frames, tracked=int(sum(ok)), commit_frame=commit,
        plain=dict(median_ms_tracked=statistics.median(tracked_ms),
                   mean_ms_tracked=statistics.fmean(tracked_ms),
                   p90_ms_tracked=float(np.percentile(tracked_ms, 90)),
                   max_ms_tracked=max(tracked_ms),
                   init_frames_ms_total=sum(init_ms),
                   tracked_fps=1e3 / statistics.fmean(tracked_ms)),
        phases=dict(total_ms=sum(times2),
                    tracked=int(sum(ok2)),
                    **{k: v for k, v in sorted(acc.items())}),
        profile=dict(window_frames=n_win,
                     wall_ms_per_frame=prof_holder["wall"] * 1e3 / n_win,
                     device_busy_ms_per_frame=busy_us / 1e3 / n_win,
                     device_busy_share=busy_us / 1e6 / prof_holder["wall"],
                     kernel_launches_per_frame=len(kernels) / n_win,
                     sync_or_copy_calls_per_frame=syncs / n_win,
                     top_kernels_ms_per_frame={
                         k: v / 1e3 / n_win
                         for k, v in by_name.most_common(15)}))))


if __name__ == "__main__":
    main()
