"""Offline dataset evaluation with the PyTorch port: run the engine over
a TUM or EuRoC sequence, report tracked-frame stats + ATE RMSE vs ground
truth, and write the TUM-format keyframe trajectory (the reference
backend's SaveKeyFrameTrajectoryTUM artifact). The counterpart of
examples/run_dataset.py without JAX or OpenCV: frames are read by the
port's own PNG reader.

Usage:
    python examples/run_dataset_torch.py /data/rgbd_dataset_freiburg1_xyz
    python examples/run_dataset_torch.py /data/MH_01_easy --device cpu

The layout (TUM rgb.txt, or EuRoC mav0/) is detected from the tree. The
engine runs on the card unless ``--device cpu``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("root", help="dataset root directory")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--traj-out", default="KeyFrameTrajectory.txt")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    args = p.parse_args()

    from send_slam_tpu_torch.config import CameraConfig, EngineConfig
    from send_slam_tpu_torch.io.dataset import (
        EurocSequence, TumSequence, open_sequence,
    )
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.models.system import System

    seq = open_sequence(args.root)
    if isinstance(seq, TumSequence):
        intr = TumSequence.FR1_INTRINSICS
        w, h = 640, 480
    else:
        intr = EurocSequence.CAM0_INTRINSICS
        w, h = 752, 480
    cfg = EngineConfig(camera=CameraConfig(width=w, height=h, **intr))
    slam = System(cfg, device=args.device)

    est_ts, est_pos = [], []
    n = n_ok = 0
    t0 = time.perf_counter()
    for ts, gray in seq:
        out = slam.track_monocular(gray.astype(np.float32), ts)
        n += 1
        if out.tracking_state == 2 and out.position is not None:
            n_ok += 1
            est_ts.append(out.timestamp)
            est_pos.append(out.position)
        # Late-emitted poses of earlier frames (init-commit backfill,
        # collapse-probe hold flush) — real poses, counted like the
        # live ones.
        for bts, bpos, _bq in out.backfill:
            n_ok += 1
            est_ts.append(bts)
            est_pos.append(bpos)
        if args.max_frames and n >= args.max_frames:
            break
    wall = time.perf_counter() - t0
    if est_ts:   # backfill arrives late: restore time order for ATE
        order = np.argsort(np.asarray(est_ts), kind="stable")
        est_ts = [est_ts[i] for i in order]
        est_pos = [est_pos[i] for i in order]

    print(f"frames: {n}, tracked: {n_ok}, "
          f"{n / wall:.1f} fps, keyframes: {int(slam.map.n_kf)}, "
          f"landmarks: {int(slam.map.n_landmarks())}, "
          f"loops: {slam.loops_closed}")
    try:
        gt_ts, gt_pos = seq.gt_positions()
        err = ate_rmse(est_ts, np.asarray(est_pos), gt_ts, gt_pos)
        print(f"ATE RMSE: {err:.4f} m")
    except (ValueError, FileNotFoundError):
        print("no ground truth available")

    with open(args.traj_out, "w") as f:
        f.write(slam.keyframe_trajectory_tum())
    print(f"keyframe trajectory -> {args.traj_out}")


if __name__ == "__main__":
    main()
