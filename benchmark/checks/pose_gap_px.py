"""``pose_gap_px``: the largest over the sampled Gauss-Newton calls of the
RMS pixel distance, over the call's inliers, between the projections
under the program's pose and under the float64 reference's.

Stage ``gn``: the robust pose-only Gauss-Newton tracking runs (both
passes, the init backfill's included; relocalization binds the function
into its own namespace, and its calls are not sampled).

Control: the robust pose Gauss-Newton, which the program runs on the
card as one hand-written kernel that TF32 does not reach, is put in its
place as its plain PyTorch version (``pose_only_gn_plain``), whose
products TF32 does reach.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from harness.capture import bind, keep_call as keep  # noqa: F401
from harness.correct import intrinsics, to_np
from reference import tracking as ref_tracking

STAGE = "gn"
SAMPLE = 32
SITES = [("send_slam_tpu_torch.models.tracking", "pose_only_gn")]

ARGS = ("R0", "t0", "X", "uv_obs", "w_valid", "fx", "fy", "cx", "cy",
        "sigma2", "rounds", "iters", "huber_delta")
DEFAULTS = dict(sigma2=None, rounds=4, iters=10, huber_delta=2.447)


def gaps(items, cam: Dict):
    fx, fy, cx, cy = intrinsics(cam)
    out_gaps = []
    for args, kwargs, out in items:
        a = bind(ARGS, DEFAULTS, args, kwargs)
        w_valid = to_np(a["w_valid"]).astype(bool)
        if not w_valid.any():
            continue
        X = to_np(a["X"]).astype(np.float64)
        s2 = a["sigma2"]
        s2 = np.ones(X.shape[0]) if s2 is None else to_np(s2)
        R, t, inl = ref_tracking.pose_gn(
            to_np(a["R0"]), to_np(a["t0"]), X, to_np(a["uv_obs"]), w_valid,
            fx, fy, cx, cy, s2, int(a["rounds"]), int(a["iters"]),
            float(a["huber_delta"]))
        mask = to_np(out.inlier).astype(bool) | inl
        gap = ref_tracking.reprojection_gap(
            to_np(out.R).astype(np.float64), to_np(out.t).astype(np.float64),
            R, t, X, mask, fx, fy, cx, cy)
        if gap is not None:
            out_gaps.append(gap)
    return out_gaps


def gap_px(items, cam: Dict) -> Optional[float]:
    g = gaps(items, cam)
    return max(g) if g else None


def value(items, config: Dict) -> Optional[float]:
    return gap_px(items, config["engine"]["camera"])


def CONTROL(patch) -> None:
    """The plain pose Gauss-Newton where ``tracking`` looks the kernel's
    entry up (relocalization's bound name is not reached)."""
    from send_slam_tpu_torch.models import tracking
    patch(tracking, "pose_only_gn", tracking.pose_only_gn_plain)
