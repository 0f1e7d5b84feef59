"""The comparison that decides ``correct``: what the window's stages
produced (``harness/capture.py``) against the plain reference
(``reference/``), worked out again from the same inputs once the window
has closed. Each number has a limit, from the configuration's
``limits``:

- ``frontend_mismatch_pct``: of the keypoints the reference finds on the
  sampled frames, the share (%) whose validity, level-0 position,
  octave, score, descriptor, angle (1e-4 rad) or undistorted position
  (1e-3 px) the program's Frame does not give;
- ``match_mismatch_pct``: of the rows either side matched in the sampled
  matcher calls, the share (%) matched otherwise;
- ``pose_gap_px``: the largest over the sampled Gauss-Newton calls of
  the RMS pixel distance, over the call's inliers, between the
  projections under the program's pose and under the float64
  reference's;
- ``ba_gap_px``: the largest over the sampled bundle adjustments (those
  of keyframe insertion and the map's bootstrap) of the median, over
  the window's observations that the reference leaves within the prune
  bound, of the pixel distance between each landmark's projection into
  its keyframe as the program's adjustment left them and as the float64
  reference's did (where a step's cost change lies within float32's
  rounding, the nearer of the reference's ends). A median, since the
  few observations that float32 moves furthest (some 1e-2 px on the
  card) would set an RMS alone;
- ``tri_gap_rel``: the largest over the landmarks that the sampled
  triangulations created of the distance between the program's point and
  the reference's from the same two pixels and poses, over the point's
  distance from the first camera.

The reference follows the program from the program's own state: the
inputs each sampled call was given (its map, matches, window).

A number with nothing to compare in a run is None and is not judged.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from harness.capture import bind
from reference import frontend as ref_frontend
from reference import mapping as ref_mapping
from reference import tracking as ref_tracking

MATCH_ARGS = ("desc_a", "desc_b", "valid_a", "valid_b", "max_dist", "ratio",
              "mutual", "extra_mask", "angles_a", "angles_b", "return_col")
MATCH_DEFAULTS = dict(max_dist=100.0, ratio=0.9, mutual=True,
                      extra_mask=None, angles_a=None, angles_b=None,
                      return_col=False)
GN_ARGS = ("R0", "t0", "X", "uv_obs", "w_valid", "fx", "fy", "cx", "cy",
           "sigma2", "rounds", "iters", "huber_delta")
GN_DEFAULTS = dict(sigma2=None, rounds=4, iters=10, huber_delta=2.447)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _words(x):
    return np.ascontiguousarray(_np(x)).view(np.uint32)


def frontend_mismatch_pct(items, orb: Dict, cam: Dict) -> Optional[float]:
    bad = total = 0
    for img, frame in items:
        ref = ref_frontend.frame_features(img, orb, cam)
        f = frame.feat
        valid = _np(f.valid)
        either = valid | ref["valid"]
        ang = np.abs(np.angle(np.exp(1j * (_np(f.angle).astype(np.float64)
                                          - ref["angle"]))))
        differs = ((valid != ref["valid"])
                   | (np.abs(_np(f.uv) - ref["uv"]).max(1) > 1e-4)
                   | (_np(f.octave) != ref["octave"])
                   | (_np(f.response) != ref["response"])
                   | (_words(f.desc) != ref["desc"]).any(1)
                   | (ang > 1e-4)
                   | (np.abs(_np(frame.uv_und) - ref["uv_und"]).max(1) > 1e-3))
        bad += int((differs & either).sum())
        total += int(either.sum())
    return None if total == 0 else 100.0 * bad / total


def match_mismatch_pct(items) -> Optional[float]:
    bad = total = 0
    for args, kwargs, out in items:
        a = bind(MATCH_ARGS, MATCH_DEFAULTS, args, kwargs)
        em = a["extra_mask"]
        idx, _, ok, col_idx, col_ok = ref_tracking.match(
            _words(a["desc_a"]), _words(a["desc_b"]), _np(a["valid_a"]),
            _np(a["valid_b"]), float(a["max_dist"]), float(a["ratio"]),
            bool(a["mutual"]), None if em is None else _np(em))
        row = out[0] if a["return_col"] else out
        p_ok, p_idx = _np(row.valid), _np(row.idx)
        either = p_ok | ok
        bad += int((either & ((p_ok != ok) | (p_idx != idx))).sum())
        total += int(either.sum())
        if a["return_col"]:
            col = out[1]
            c_ok, c_idx = _np(col.valid), _np(col.idx)
            c_either = c_ok | col_ok
            bad += int((c_either & ((c_ok != col_ok)
                                    | (c_idx != col_idx))).sum())
            total += int(c_either.sum())
    return None if total == 0 else 100.0 * bad / total


def _intrinsics(cam: Dict):
    return tuple(float(cam[k]) for k in ("fx", "fy", "cx", "cy"))


def pose_gaps(items, cam: Dict):
    fx, fy, cx, cy = _intrinsics(cam)
    gaps = []
    for args, kwargs, out in items:
        a = bind(GN_ARGS, GN_DEFAULTS, args, kwargs)
        w_valid = _np(a["w_valid"]).astype(bool)
        if not w_valid.any():
            continue
        X = _np(a["X"]).astype(np.float64)
        s2 = a["sigma2"]
        s2 = np.ones(X.shape[0]) if s2 is None else _np(s2)
        R, t, inl = ref_tracking.pose_gn(
            _np(a["R0"]), _np(a["t0"]), X, _np(a["uv_obs"]), w_valid, fx, fy,
            cx, cy, s2, int(a["rounds"]), int(a["iters"]),
            float(a["huber_delta"]))
        mask = _np(out.inlier).astype(bool) | inl
        gap = ref_tracking.reprojection_gap(
            _np(out.R).astype(np.float64), _np(out.t).astype(np.float64), R,
            t, X, mask, fx, fy, cx, cy)
        if gap is not None:
            gaps.append(gap)
    return gaps


def pose_gap_px(items, cam: Dict) -> Optional[float]:
    gaps = pose_gaps(items, cam)
    return max(gaps) if gaps else None


def ba_gaps(items, cam: Dict, scale_factor: float):
    """Per sampled call, the gap to the nearest end the reference can
    reach (``reference.mapping.local_ba``)."""
    fx, fy, cx, cy = _intrinsics(cam)
    gaps = []
    for it in items:
        st = {k: _np(v) for k, v in it["before"].items()}
        a = {k: _np(v) for k, v in it["args"].items()}
        wid = a["window_ids"]
        gid, _, ends = ref_mapping.local_ba(
            st, fx, fy, cx, cy, int(a["ba_window"]), int(a["iters"]),
            float(a["huber_delta"]), float(a["damping"]),
            scale_factor, int(a["n_fixed"]), wid)
        _, _, w, n, l = ref_mapping.window_obs(st, int(a["ba_window"]), wid)
        out = {k: _np(v).astype(np.float64) for k, v in it["after"].items()}
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
            keep = (p[:, 2] > 1e-3) & (chi2 < bound)
            if keep.any():
                gap = float(np.median(np.hypot(up - ur, vp - vr)[keep]))
                best = gap if best is None else min(best, gap)
        if best is not None:
            gaps.append(best)
    return gaps


def ba_gap_px(items, cam: Dict, scale_factor: float) -> Optional[float]:
    gaps = ba_gaps(items, cam, scale_factor)
    return max(gaps) if gaps else None


def tri_gaps(items, cam: Dict):
    """Per sampled call, the largest relative gap over its new landmarks
    (calls that created none are left out)."""
    fx, fy, cx, cy = _intrinsics(cam)
    gaps = []
    for it in items:
        b = {k: _np(v) for k, v in it["before"].items()}
        a = {k: _np(v) for k, v in it["after"].items()}
        kn, kr = int(_np(it["kf_new"])), int(_np(it["kf_ref"]))
        new = np.flatnonzero(a["lm_valid"] & ~b["lm_valid"])
        if new.size == 0 or kn == kr:
            continue
        obs_r, obs_n = a["kf_obs_lm"][kr], a["kf_obs_lm"][kn]
        kp_r = np.full(a["lm_valid"].shape[0], -1)
        kp_n = kp_r.copy()
        kp_r[obs_r[obs_r >= 0]] = np.flatnonzero(obs_r >= 0)
        kp_n[obs_n[obs_n >= 0]] = np.flatnonzero(obs_n >= 0)
        if (kp_r[new] < 0).any() or (kp_n[new] < 0).any():
            gaps.append(float("inf"))       # a new point not observed
            continue
        R, t = b["kf_R"].astype(np.float64), b["kf_t"].astype(np.float64)
        X = ref_mapping.triangulate(R[kr], t[kr], R[kn], t[kn], fx, fy, cx,
                                    cy, b["kf_uv"][kr][kp_r[new]],
                                    b["kf_uv"][kn][kp_n[new]])
        centre = -R[kr].T @ t[kr]
        dist = np.linalg.norm(X - centre, axis=1)
        gap = np.linalg.norm(a["lm_pos"][new].astype(np.float64) - X, axis=1)
        gaps.append(float((gap / np.maximum(dist, 1e-9)).max()))
    return gaps


def tri_gap_rel(items, cam: Dict) -> Optional[float]:
    gaps = tri_gaps(items, cam)
    return max(gaps) if gaps else None


def compare(stash, config: Dict) -> Dict:
    """{number: value or None}, each from its stage's sample."""
    engine = config["engine"]
    cam, orb = engine["camera"], engine["orb"]
    return dict(
        frontend_mismatch_pct=frontend_mismatch_pct(
            stash.items("frontend"), orb, cam),
        match_mismatch_pct=match_mismatch_pct(stash.items("match")),
        pose_gap_px=pose_gap_px(stash.items("gn"), cam),
        ba_gap_px=ba_gap_px(stash.items("ba"), cam, orb["scale_factor"]),
        tri_gap_rel=tri_gap_rel(stash.items("tri"), cam))


def judge(values: Dict, limits: Dict):
    """(correct, {name: {"value", "limit"}}): every number with a value
    within its limit, and at least one number compared."""
    checks = {k: dict(value=v, limit=limits[k]) for k, v in values.items()}
    judged = [c for c in checks.values() if c["value"] is not None]
    ok = bool(judged) and all(c["value"] <= c["limit"] for c in judged)
    return ok, checks
