"""``ba_gap_px``: the largest over the sampled bundle adjustments (those of
keyframe insertion and the map's bootstrap) of the median, over the
window's observations that the reference leaves within the prune bound,
of the pixel distance between each landmark's projection into its
keyframe as the program's adjustment left them and as the float64
reference's did (where a step's cost change lies within float32's
rounding, the nearer of the reference's ends). A median, since the few
observations that float32 moves furthest (some 1e-2 px on the card)
would set an RMS alone.

Stage ``ba``: local bundle adjustment of several iterations at the
configured damping, as keyframe insertion and the init's map bootstrap
run it. The one-iteration slices between keyframes are not kept: at
their small damping (down to 3e-5) the reduced pose system is so
ill-conditioned that float32's rounding alone moves their result by
some 1e-3 px on the card. A kept map is the references to the arrays
the adjustment reads: the program replaces a map's arrays and never
writes into them, so nothing is copied inside the window.

Control: bundle adjustment's residual, weight and Jacobian planes,
float32 work that is no matrix product, are rounded to bfloat16 where
they are produced, as a fused kernel with bfloat16 operands and float32
sums would take them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from harness.capture import bind
from harness.correct import intrinsics, to_np
from reference import mapping as ref_mapping

STAGE = "ba"
SAMPLE = 8
SITES = [("send_slam_tpu_torch.models.system", "local_bundle_adjustment"),
         ("send_slam_tpu_torch.models.local_mapping",
          "local_bundle_adjustment")]

ARGS = ("m", "K", "cfg", "iters", "huber_delta", "damping", "scale_factor",
        "n_fixed", "window_ids", "prune", "chi2_prune_mult")
DEFAULTS = dict(iters=5, huber_delta=2.447, damping=1e-3, scale_factor=1.2,
                n_fixed=2, window_ids=None, prune=True, chi2_prune_mult=4.0)
READS = ("kf_R", "kf_t", "kf_uv", "kf_octave", "kf_obs_lm", "kf_kp_valid",
         "kf_valid", "lm_valid", "lm_pos", "n_kf")


def keep_all(args, kwargs, out):
    """What any adjustment read and wrote, one-iteration slices too."""
    a = bind(ARGS, DEFAULTS, args, kwargs)
    m = a.pop("m")
    a["ba_window"] = a.pop("cfg").ba_window
    del a["K"]
    return dict(args=a, before={k: getattr(m, k) for k in READS},
                after=dict(kf_R=out.kf_R, kf_t=out.kf_t, lm_pos=out.lm_pos))


def keep(args, kwargs, out):
    item = keep_all(args, kwargs, out)
    return item if int(item["args"]["iters"]) > 1 else []


def gaps(items, cam: Dict, scale_factor: float):
    """Per sampled call, the gap to the nearest end the reference can
    reach (``reference.mapping.local_ba``)."""
    fx, fy, cx, cy = intrinsics(cam)
    out_gaps = []
    for it in items:
        st = {k: to_np(v) for k, v in it["before"].items()}
        a = {k: to_np(v) for k, v in it["args"].items()}
        wid = a["window_ids"]
        gid, _, ends = ref_mapping.local_ba(
            st, fx, fy, cx, cy, int(a["ba_window"]), int(a["iters"]),
            float(a["huber_delta"]), float(a["damping"]),
            scale_factor, int(a["n_fixed"]), wid)
        _, _, w, n, l = ref_mapping.window_obs(st, int(a["ba_window"]), wid)
        out = {k: to_np(v).astype(np.float64) for k, v in it["after"].items()}
        uv = st["kf_uv"][gid][w, n]
        s2 = scale_factor ** (2.0 * st["kf_octave"][gid][w, n])
        bound = float(a["chi2_prune_mult"]) * ref_mapping.CHI2_2DOF
        up, vp, _ = ref_mapping.project(out["kf_R"][gid][w],
                                        out["kf_t"][gid][w],
                                        out["lm_pos"][l], fx, fy, cx, cy)
        best = None
        for R, t, X in ends:
            ur, vr, p = ref_mapping.project(R[w], t[w], X[l], fx, fy, cx, cy)
            # The observations this end leaves within the prune bound: a
            # point that it throws far off projects anywhere.
            chi2 = ((ur - uv[:, 0]) ** 2 + (vr - uv[:, 1]) ** 2) / s2
            ok = (p[:, 2] > 1e-3) & (chi2 < bound)
            if ok.any():
                gap = float(np.median(np.hypot(up - ur, vp - vr)[ok]))
                best = gap if best is None else min(best, gap)
        if best is not None:
            out_gaps.append(best)
    return out_gaps


def gap_px(items, cam: Dict, scale_factor: float) -> Optional[float]:
    g = gaps(items, cam, scale_factor)
    return max(g) if g else None


def value(items, config: Dict) -> Optional[float]:
    engine = config["engine"]
    return gap_px(items, engine["camera"], engine["orb"]["scale_factor"])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def obs_terms_bf16(orig):
    def terms(*a, **kw):
        *planes, pz = orig(*a, **kw)
        return tuple(_bf16(p) for p in planes) + (pz,)
    return terms


def CONTROL(patch) -> None:
    """The bfloat16 planes where ``local_ba`` looks ``_obs_terms`` up."""
    from send_slam_tpu_torch.models import local_ba
    patch(local_ba, "_obs_terms", obs_terms_bf16(local_ba._obs_terms))
