"""Card timings that compare two trees of the port in one call.

    python send_slam_tpu_torch/ab_timing.py [--root DIR] [--frames 90]

Imports ``send_slam_tpu_torch`` from ``--root`` (default: the tree this
file is in), so the same script times a checkout of an earlier commit:
run parent, change, change, parent in one call and compare within it.
It uses only entry points every tree of the port has. Prints one JSON
object:

- ``ba``: ``local_bundle_adjustment`` on a synthetic map at the flagship
  capacities (256 keyframes, 16384 landmarks, 1250 keypoints; 72
  keyframes of about 900 observations each), one iteration over the
  newest 8 and the newest 64 keyframes: median, min and max ms per call
  over 20 calls, each ending in a device sync (the host's launch time
  included, as the main path pays it), and whether two calls on the
  same input gave the same bits;
- ``main_path``: ``System(slice_config(...))`` at the flagship
  configuration over ``--frames`` frames of the synthetic bench scene
  (seed 11): median and mean ms per tracked (pose-emitting) frame, each
  frame ending in a device sync, and the frames tracked.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def _flagship_map(torch, ms, MapConfig, n_kf=72, seed=3):
    """A map at the flagship capacities: n_kf keyframes along a forward
    path observing a 12,000-point cloud with 0.5 px noise."""
    rng = np.random.default_rng(seed)
    MK, ML, N = 256, 16384, 1250
    fx = fy = 520.0
    cx, cy = 320.0, 240.0
    m = ms.map_to_numpy(ms.empty_map(MapConfig(), N, device="cpu"))
    n_pts = 12000
    P = np.concatenate([rng.uniform(-6, 6, (n_pts, 1)),
                        rng.uniform(-4, 4, (n_pts, 1)),
                        rng.uniform(4, 40, (n_pts, 1))], 1)
    m["lm_pos"][:n_pts] = P + rng.normal(0, 0.01, P.shape)
    m["lm_valid"][:n_pts] = True
    m["lm_ref_kf"][:n_pts] = 0
    for k in range(n_kf):
        a = 0.004 * k
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        C = np.array([0.02 * k, 0.0, 0.25 * k])
        t = -R @ C
        p = P @ R.T + t
        uv = np.stack([fx * p[:, 0] / p[:, 2] + cx,
                       fy * p[:, 1] / p[:, 2] + cy], -1)
        vis = np.nonzero((p[:, 2] > 1) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
                         & (uv[:, 1] > 0) & (uv[:, 1] < 480))[0]
        vis = rng.permutation(vis)[:900]
        slots = rng.permutation(N)[:len(vis)]
        m["kf_R"][k] = R
        m["kf_t"][k] = t + (rng.normal(0, 0.005, 3) if k > 1 else 0)
        m["kf_uv"][k] = rng.uniform(0, 480, (N, 2))
        m["kf_uv"][k, slots] = uv[vis] + rng.normal(0, 0.5, (len(vis), 2))
        m["kf_octave"][k] = rng.integers(0, 8, N)
        m["kf_kp_valid"][k] = True
        m["kf_obs_lm"][k, slots] = vis
        m["kf_valid"][k] = True
        m["kf_timestamp"][k] = k / 30.0
    m["n_kf"] = np.asarray(n_kf, np.int32)
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                     dtype=torch.float32, device="cuda")
    return ms.map_from_numpy(m, device="cuda"), K


def time_ba(torch, calls=20):
    from send_slam_tpu_torch.config import MapConfig
    from send_slam_tpu_torch.models import map_state as ms
    from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
    m, K = _flagship_map(torch, ms, MapConfig)
    out = {}
    for W in (8, 64):
        cfg = MapConfig(ba_window=W)

        def call():
            return local_bundle_adjustment(m, K, cfg, iters=1, damping=1e-3,
                                           prune=False)

        a = call()
        b = call()
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("kf_R", "kf_t", "lm_pos"))
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"window_{W}"] = dict(
            median_ms=statistics.median(times), min_ms=min(times),
            max_ms=max(times), calls=calls, bit_equal_repeat=same,
            moved=float((a.lm_pos - m.lm_pos).abs().max()))
    return out


def time_main_path(torch, n_frames):
    from send_slam_tpu_torch.config import CameraConfig, EngineConfig
    from send_slam_tpu_torch.models.system import System, slice_config
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=n_frames)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(n_frames)]
    cfg = slice_config(EngineConfig(camera=CameraConfig(
        width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0)))
    s = System(cfg, device="cuda")
    t_ok, stamps = [], set()
    for k in range(n_frames):
        t0 = time.perf_counter()
        out = s.track_monocular(frames[k], float(ts[k]))
        torch.cuda.synchronize()
        if out.tracking_state == 2:
            t_ok.append((time.perf_counter() - t0) * 1e3)
            stamps.add(out.timestamp)
        stamps.update(b[0] for b in getattr(out, "backfill", ()))
    for out in s.shutdown():
        if out.tracking_state == 2:
            stamps.add(out.timestamp)
        stamps.update(b[0] for b in getattr(out, "backfill", ()))
    return dict(frames=n_frames, tracked_unique=len(stamps),
                tracked_live=len(t_ok),
                median_ms_per_tracked_frame=statistics.median(t_ok[1:]),
                mean_ms_per_tracked_frame=statistics.fmean(t_ok[1:]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=90)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import send_slam_tpu_torch
    if not torch.cuda.is_available():
        print("ab_timing: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    res = dict(root=os.path.abspath(args.root),
               package=os.path.dirname(send_slam_tpu_torch.__file__),
               nvidia_smi=smi[0] if smi else None, ba=time_ba(torch),
               main_path=time_main_path(torch, args.frames))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
