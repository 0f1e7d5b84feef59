"""Tracking of the port against the JAX package (eager, CPU): pose-only
Gauss-Newton and the two-pass search-by-projection tracker with its
frustum/octave/distance gates and rescue pass, on a seeded synthetic
landmark table. Poses within 1e-4 and inlier counts within +-1: the
same f32 formulas with a different summation order in the 6x6 normal
equations (the pose bar the init uses too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from send_slam_tpu.config import TrackingConfig as JTr
from send_slam_tpu.geometry.se3 import so3_exp as jso3
from send_slam_tpu.models import tracking as jtrk
from send_slam_tpu_torch.config import TrackingConfig as TTr
from send_slam_tpu_torch.models import tracking as ttrk

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

FX, FY, CX, CY, W, H = 260.0, 260.0, 160.0, 120.0, 320, 240


def T(x):
    return torch.from_numpy(np.array(x))


def pose(rvec, t):
    return np.asarray(jso3(jnp.asarray(rvec, jnp.float32))), \
        np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(12)
    L, M = 400, 300
    X = np.concatenate([rng.uniform(-4, 4, (L, 2)), rng.uniform(3, 9, (L, 1))],
                       -1).astype(np.float32)
    lm_desc = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint64).astype(np.uint32)
    lm_valid = rng.random(L) < 0.95
    R, t = pose([0.01, -0.03, 0.005], [0.08, -0.02, 0.05])
    p = X @ R.T + t
    uv = np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY], -1)
    vis = np.nonzero((uv[:, 0] > 5) & (uv[:, 0] < W - 5) & (uv[:, 1] > 5)
                     & (uv[:, 1] < H - 5) & lm_valid)[0][:220]
    kp_uv = rng.uniform([0, 0], [W, H], (M, 2)).astype(np.float32)
    kp_desc = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    slots = rng.permutation(M)[:len(vis)]
    kp_uv[slots] = uv[vis] + rng.normal(0, 0.4, (len(vis), 2))
    for s, l in zip(slots, vis):
        d = lm_desc[l].copy()
        for _ in range(rng.integers(0, 20)):
            w_, b_ = rng.integers(0, 8), rng.integers(0, 32)
            d[w_] ^= np.uint32(1 << int(b_))
        kp_desc[s] = d
    kp_oct = rng.integers(0, 4, M).astype(np.int32)
    kp_valid = rng.random(M) < 0.97
    # Viewing statistics from a reference camera at the origin; some
    # landmarks carry none (dist_max = 0 passes ungated).
    dist = np.linalg.norm(X, axis=1)
    normal = (X / dist[:, None]).astype(np.float32)
    oct_l = rng.integers(0, 4, L)
    dmax = (dist * 1.2 ** oct_l).astype(np.float32)
    dmin = (dmax / 1.2 ** 7).astype(np.float32)
    dmax[rng.random(L) < 0.1] = 0.0
    return dict(X=X, lm_desc=lm_desc, lm_valid=lm_valid, kp_uv=kp_uv,
                kp_desc=kp_desc, kp_oct=kp_oct, kp_valid=kp_valid,
                normal=normal, dmin=dmin, dmax=dmax, R=R, t=t, vis=vis,
                slots=slots)


def test_pose_only_gn(scene):
    s = scene
    X = s["X"][s["vis"]]
    uv = s["kp_uv"][s["slots"]]
    w = np.ones(len(X), bool)
    w[::17] = False
    uv[::11] += 25.0                                   # outliers
    sigma2 = (1.2 ** s["kp_oct"][s["slots"]].astype(np.float32)) ** 2
    R0, t0 = pose([0.02, -0.01, 0.0], [0.05, 0.0, 0.1])
    j = jtrk.pose_only_gn(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                          jnp.asarray(uv), jnp.asarray(w), FX, FY, CX, CY,
                          sigma2=jnp.asarray(sigma2), rounds=4, iters=5)
    t = ttrk.pose_only_gn(T(R0), T(t0), T(X), T(uv), T(w), FX, FY, CX, CY,
                          sigma2=T(sigma2), rounds=4, iters=5)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert abs(int(t.n_inliers) - int(j.n_inliers)) <= 1
    np.testing.assert_allclose(t.R.numpy(), s["R"], atol=5e-3)


@pytest.mark.parametrize("case", ["gated", "ungated", "rescue"])
def test_track_frame(scene, case):
    s = scene
    if case == "rescue":
        # A prediction far off starves both passes; the rescue pass from
        # the true pose recovers.
        Rp, tp = pose([0.2, 0.1, 0.0], [1.0, 0.5, 0.0])
        Rr, tr_ = s["R"], s["t"]
    else:
        Rp, tp = pose([0.012, -0.028, 0.004], [0.07, -0.03, 0.06])
        Rr, tr_ = Rp, tp
    gate = case != "ungated"

    def run(mod, cfg, A, desc):
        kw = dict(R_rescue=A(Rr), t_rescue=A(tr_), n_levels=8,
                  search_radius=15.0)
        if gate:
            kw.update(lm_normal=A(s["normal"]), lm_dist_min=A(s["dmin"]),
                      lm_dist_max=A(s["dmax"]))
        return mod.track_frame(
            A(Rp), A(tp), A(s["X"]), desc(s["lm_desc"]), A(s["lm_valid"]),
            A(s["kp_uv"]), desc(s["kp_desc"]), A(s["kp_valid"]),
            A(s["kp_oct"]), FX, FY, CX, CY, W, H, cfg, **kw)

    j = run(jtrk, JTr(), jnp.asarray, jnp.asarray)
    t = run(ttrk, TTr(), T, lambda d: T(d.view(np.int32)))
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert abs(int(t.n_inliers) - int(j.n_inliers)) <= 1
    assert int(j.n_inliers) > 100
    np.testing.assert_array_equal(np.asarray(j.in_view), t.in_view.numpy())
    same = (np.asarray(j.matches.idx) == t.matches.idx.numpy()).mean()
    assert same > 0.99
    assert abs(int(np.asarray(j.inlier).sum()) - int(t.inlier.sum())) <= 1
