"""``tri_gap_rel``: the largest over the landmarks that the sampled
triangulations created of the distance between the program's point and
the reference's from the same two pixels and poses, over the point's
distance from the first camera.

Stage ``tri``: the two-view triangulation of new landmarks that keyframe
insertion runs against each earlier keyframe.

Control: the new landmarks' triangulation, which the program forms and
solves in float64, is put in its place in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from harness.capture import bind
from harness.correct import intrinsics, to_np
from reference import mapping as ref_mapping

STAGE = "tri"
SAMPLE = 8
SITES = [("send_slam_tpu_torch.models.local_mapping",
          "create_new_landmarks")]

ARGS = ("m", "kf_new", "kf_ref")


def keep(args, kwargs, out):
    a = bind(ARGS, {}, args, kwargs)
    m, after = a["m"], out[0]
    return dict(kf_new=a["kf_new"], kf_ref=a["kf_ref"],
                before=dict(kf_R=m.kf_R, kf_t=m.kf_t, kf_uv=m.kf_uv,
                            lm_valid=m.lm_valid),
                after=dict(lm_valid=after.lm_valid, lm_pos=after.lm_pos,
                           kf_obs_lm=after.kf_obs_lm))


def gaps(items, cam: Dict):
    """Per sampled call, the largest relative gap over its new landmarks
    (calls that created none are left out)."""
    fx, fy, cx, cy = intrinsics(cam)
    out = []
    for it in items:
        b = {k: to_np(v) for k, v in it["before"].items()}
        a = {k: to_np(v) for k, v in it["after"].items()}
        kn, kr = int(to_np(it["kf_new"])), int(to_np(it["kf_ref"]))
        new = np.flatnonzero(a["lm_valid"] & ~b["lm_valid"])
        if new.size == 0 or kn == kr:
            continue
        obs_r, obs_n = a["kf_obs_lm"][kr], a["kf_obs_lm"][kn]
        kp_r = np.full(a["lm_valid"].shape[0], -1)
        kp_n = kp_r.copy()
        kp_r[obs_r[obs_r >= 0]] = np.flatnonzero(obs_r >= 0)
        kp_n[obs_n[obs_n >= 0]] = np.flatnonzero(obs_n >= 0)
        if (kp_r[new] < 0).any() or (kp_n[new] < 0).any():
            out.append(float("inf"))       # a new point not observed
            continue
        R, t = b["kf_R"].astype(np.float64), b["kf_t"].astype(np.float64)
        X = ref_mapping.triangulate(R[kr], t[kr], R[kn], t[kn], fx, fy, cx,
                                    cy, b["kf_uv"][kr][kp_r[new]],
                                    b["kf_uv"][kn][kp_n[new]])
        centre = -R[kr].T @ t[kr]
        dist = np.linalg.norm(X - centre, axis=1)
        gap = np.linalg.norm(a["lm_pos"][new].astype(np.float64) - X, axis=1)
        out.append(float((gap / np.maximum(dist, 1e-9)).max()))
    return out


def gap_rel(items, cam: Dict) -> Optional[float]:
    g = gaps(items, cam)
    return max(g) if g else None


def value(items, config: Dict) -> Optional[float]:
    return gap_rel(items, config["engine"]["camera"])


def triangulate_batch_f32(P1, P2, x1, x2):
    """The linear triangulation's normal equations (the DLT rows with the
    point's fourth coordinate 1) formed and solved in float32."""
    P1, P2, x1, x2 = (v.float() for v in (P1, P2, x1, x2))
    rows = []
    for P, x in ((P1, x1), (P2, x2)):
        r2 = P[..., 2, :].unsqueeze(-2)
        rows.append(x[..., 0:1] * r2 - P[..., 0, :].unsqueeze(-2))
        rows.append(x[..., 1:2] * r2 - P[..., 1, :].unsqueeze(-2))
    A = torch.stack(torch.broadcast_tensors(*rows), -2)      # (N, 4, 4)
    M, b = A[..., :3], -A[..., 3]
    MtM = M.transpose(-1, -2) @ M
    Mtb = (M * b[..., None]).sum(-2)
    return torch.linalg.solve_ex(MtM, Mtb[..., None])[0][..., 0]


def CONTROL(patch) -> None:
    """The float32 triangulation where ``local_mapping`` looks it up."""
    from send_slam_tpu_torch.models import local_mapping
    patch(local_mapping, "triangulate_batch", triangulate_batch_f32)
