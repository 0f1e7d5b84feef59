"""The main path of chip_smoke.py on the CPU, in either package.

    JAX_PLATFORMS=cpu python scripts/cpu_reference_run.py --package jax
    python scripts/cpu_reference_run.py --package torch

Runs ``System.track_monocular`` at chip_smoke.py's main-path
configuration (640x480, 1250 features, 8 levels, 256 keyframes, 16384
landmarks, BA window 8, the default tracking options with loop closing
off) over the 90 frames of the synthetic bench scene (seed 11), counts
poses as bench.py does (live OK outputs, backfill triples, the final
drain) and prints one JSON line: tracked, live, backfilled, unique
timestamps, ATE, keyframes, the init commit time and every collapse-probe
verdict (commit time, probe time, velocity ratio).

The port draws its RANSAC samples from a CPU generator on every device,
so ``--package torch`` here takes the same draws as the port's run on
the card; ``--package jax`` is the reference at the same configuration.
A run takes one to two minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--frames", type=int, default=90)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from send_slam_tpu import config as C
        from send_slam_tpu.models import system as S
        make = (lambda cfg: S.System(cfg))
        loop_off = dict(loop_min_gap_kf=10 ** 6)
    else:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
        from send_slam_tpu_torch import config as C
        from send_slam_tpu_torch.models import system as S
        make = (lambda cfg: S.System(cfg, device="cpu"))
        loop_off = dict(loop_min_gap_kf=256)
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.utils.synth import SyntheticWorld

    cfg = C.EngineConfig(
        camera=C.CameraConfig(width=640, height=480, fx=520.0, fy=520.0,
                              cx=320.0, cy=240.0),
        tracking=C.TrackingConfig(**loop_off))
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=args.frames)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(args.frames)]
    s = make(cfg)
    probes = []
    retry = S.System._collapse_retry

    def spy(self, ts_rel):
        trc = self._collapse_trace
        span = trc[-1][0] - trc[0][0]
        v = float(np.linalg.norm(trc[-1][1] - trc[0][1])) / span
        probes.append((self.init_commit_ts, ts_rel, v / self._init_v))
        return retry(self, ts_rel)

    S.System._collapse_retry = spy
    live = backfilled = 0
    est = []
    t0 = time.perf_counter()
    outs = [s.track_monocular(frames[k], float(ts[k]))
            for k in range(args.frames)]
    for out in outs + list(s._flush_pipeline(final=True)):
        if out.tracking_state == 2:
            live += 1
            est.append((out.timestamp, out.position))
        backfilled += len(out.backfill)
        est.extend((b[0], b[1]) for b in out.backfill)
    est.sort(key=lambda e: e[0])
    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])
    ate = ate_rmse([e[0] for e in est], np.asarray([e[1] for e in est]),
                   ts, gt) if len(est) >= 3 else float("inf")
    print(json.dumps(dict(
        package=args.package, frames=args.frames, tracked=len(est),
        tracked_live=live, backfilled=backfilled,
        tracked_unique=len({e[0] for e in est}), ate_m=ate,
        keyframes=int(s._n_kf_host), init_commit_ts=s.init_commit_ts,
        failed_collapse_probes=probes,
        seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
