"""Per-frame time of the main path called from the main thread, from a
worker thread, and through an asyncio event loop's executor as the
server paths call it, in turns on one card.

    python scripts/thread_ab.py [--reps 2]

Each run is chip_smoke.py's main path (the flagship configuration, the
90 bench frames of seed 11) on a fresh System; the modes alternate
(main, worker, loop, loop, worker, main, ...). A frame's time runs from
the call to the device sync after it, taken on the thread that made the
call; the median and mean over the tracked (OK) frames but the first
are printed per run, with the poses checked bit-equal across runs. One
JSON line. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("thread_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from send_slam_tpu_torch.models.system import TRACKING_OK, System
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=chip_smoke.N_FRAMES)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(chip_smoke.N_FRAMES)]
    cfg = chip_smoke.flagship_config()

    def frame(system, k):
        t0 = time.perf_counter()
        out = system.track_monocular(frames[k].astype(np.float32),
                                     float(ts[k]))
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def one_run(mode, pool):
        system = System(cfg, device="cuda")
        outs = []
        if mode == "main":
            outs = [frame(system, k) for k in range(len(frames))]
        elif mode == "worker":
            outs = [pool.submit(frame, system, k).result()
                    for k in range(len(frames))]
        else:
            async def go():
                loop = asyncio.get_running_loop()
                return [await loop.run_in_executor(None, frame, system, k)
                        for k in range(len(frames))]
            outs = asyncio.run(go())
        ms = [t for o, t in outs if o.tracking_state == TRACKING_OK][1:]
        poses = [(o.timestamp, o.position.tolist()) for o, _ in outs
                 if o.tracking_state == TRACKING_OK]
        return dict(mode=mode, median_ms=statistics.median(ms),
                    mean_ms=statistics.fmean(ms), tracked=len(ms) + 1), poses

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    order = []
    for r in range(args.reps):
        turn = ["main", "worker", "loop"]
        order += turn if r % 2 == 0 else turn[::-1]
    runs, first = [], None
    with ThreadPoolExecutor(1) as pool:
        one_run("main", pool)                   # build, handles, allocator
        for mode in order:
            res, poses = one_run(mode, pool)
            first = first if first is not None else poses
            res["poses_equal"] = poses == first
            runs.append(res)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          nvidia_smi=smi, runs=runs)), flush=True)
    return 0 if all(r["poses_equal"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
