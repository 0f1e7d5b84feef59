"""chip_smoke.py's lanes_path scene over several seeds of the lanes'
draws (ROADMAP C.2).

    python scripts/lanes_seeds.py --seeds 0 1 2 3 4          # the card
    python scripts/lanes_seeds.py --seeds 0 --device cpu

Each seed runs two flagship lanes (``init_multicam(seed=)``) on
lanes_path's scene as chip_smoke.py does: 70 steps, the ring merge with
its Gumbel draws (seed 15), 10 steps more. Prints one JSON line per seed:
for each lane its commit step, the steps at which it fell out of
TRACKING (resets), its tracked share after the commit, kf_total, final
mode, the Sim(3)-aligned ATE, and the merge's verdict and imports; the
same fields as ``scripts/cpu_reference_run.py --scene lanes --seed``
prints for either package on the CPU.
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
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from send_slam_tpu_torch.parallel import (
        init_multicam, make_mesh, multicam_slam_step,
    )
    from send_slam_tpu_torch.parallel.map_merge import (
        merge_noise, multicam_merge_step,
    )
    from send_slam_tpu_torch.parallel.multicam import MODE_TRACKING
    cfg = cs.flagship_config()
    world, ts, poses, centres = cs.lanes_scene()
    mesh = make_mesh(1, devices=[args.device])
    step = multicam_slam_step(cfg, mesh, loop_closing=True)
    merge = multicam_merge_step(cfg, mesh)
    n_steps = cs.LANES_MERGE_AFTER + cs.LANES_AFTER
    rendered = [np.stack([np.round(world.render(*poses[c][k]))
                          .astype(np.uint8) for c in range(2)])
                for k in range(n_steps)]
    name = (torch.cuda.get_device_name(0) if args.device != "cpu"
            else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        state = init_multicam(cfg, 2, device=args.device, seed=seed)
        rows = []
        for k in range(n_steps):
            if k == cs.LANES_MERGE_AFTER:
                pre = state.maps.lm_valid.cpu().numpy()
                merged, ok, n_imp = merge(
                    state.maps, merge_noise(2, cfg.map.max_landmarks,
                                            seed=15))
                state = state._replace(maps=merged)
            state, summary = step(state, rendered[k],
                                  np.full(2, ts[k], np.float32))
            rows.append(summary.cpu().numpy())
        rows = np.asarray(rows)
        ates = cs.lane_ates(rows, ts, centres)
        lanes = []
        for c in range(2):
            tracked = rows[:, c, 0] == MODE_TRACKING
            first = int(np.argmax(tracked)) if tracked.any() else None
            n_imported, med = cs.import_structure(
                pre[c], merged.lm_valid[c].cpu().numpy(),
                merged.lm_pos[c].cpu().numpy(), ates[c][1], world.points)
            lanes.append(dict(
                commit_step=first,
                reset_steps=[k for k in range(1, n_steps)
                             if tracked[k - 1] and not tracked[k]],
                tracking_share_after_commit=(float(tracked[first:].mean())
                                             if first is not None else 0.0),
                kf_total=int(rows[-1, c, 8]),
                final_mode=int(rows[-1, c, 0]), ate_m=ates[c][0],
                merge_ok=bool(ok[c]), imported=int(n_imp[c]),
                import_median_to_structure_m=med))
        print(json.dumps(dict(package="torch", device=name, scene="lanes",
                              seed=seed, steps=n_steps, lanes=lanes,
                              seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
