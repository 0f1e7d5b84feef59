"""Geometry of the port against the JAX package (eager, CPU): SE3, camera
models, triangulation, epipolar estimators and homography decomposition.
Tolerance 1e-5 relative unless stated: same f32 formulas, summation order
in small matmuls differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from send_slam_tpu.geometry import camera as jcam, epipolar as jepi
from send_slam_tpu.geometry import homography as jhom, se3 as jse3
from send_slam_tpu.geometry import triangulate as jtri
from send_slam_tpu_torch.geometry import camera as tcam, epipolar as tepi
from send_slam_tpu_torch.geometry import homography as thom, se3 as tse3
from send_slam_tpu_torch.geometry import triangulate as ttri

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def test_so3_se3_roundtrips(rng):
    phi = rng.normal(size=(32, 3)).astype(np.float32)
    phi[:4] *= 1e-5                                   # small-angle branch
    phi[4] = [np.pi - 1e-4, 0.0, 0.0]                 # near-pi branch
    close(tse3.so3_exp(T(phi)), jse3.so3_exp(jnp.asarray(phi)))
    R = np.asarray(jse3.so3_exp(jnp.asarray(phi)))
    close(tse3.so3_log(T(R)), jse3.so3_log(jnp.asarray(R)), atol=2e-4)
    xi = rng.normal(size=(32, 6)).astype(np.float32) * 0.5
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(T(xi))
    close(Rt, Rj)
    close(tt, tj)
    close(tse3.se3_log(Rt, tt), jse3.se3_log(Rj, tj), atol=1e-4)
    Ri, ti = tse3.se3_inverse(Rt, tt)
    Rji, tji = jse3.se3_inverse(Rj, tj)
    close(Ri, Rji)
    close(ti, tji)
    Rc, tc = tse3.se3_compose(Rt, tt, Ri, ti)
    Rjc, tjc = jse3.se3_compose(Rj, tj, Rji, tji)
    close(Rc, Rjc)
    close(tc, tjc)
    close(tse3.quat_from_rotmat(Rt), jse3.quat_from_rotmat(Rj))


def test_camera_models(rng):
    pts = np.concatenate([rng.uniform(-2, 2, (64, 2)),
                          rng.uniform(2, 8, (64, 1))], -1).astype(np.float32)
    args = (260.0, 255.0, 160.0, 120.0)
    close(tcam.project(T(pts), *args), jcam.project(jnp.asarray(pts), *args))
    dist = np.array([0.1, -0.05, 0.002, -0.001, 0.01], np.float32)
    uv = np.asarray(jcam.project(jnp.asarray(pts), *args, dist=jnp.asarray(dist)))
    close(tcam.project(T(pts), *args, dist=T(dist)), uv)
    close(tcam.undistort_points(T(uv), *args, T(dist)),
          jcam.undistort_points(jnp.asarray(uv), *args, jnp.asarray(dist)),
          atol=1e-4)
    kb = np.array([0.02, -0.01, 0.003, -0.001], np.float32)
    uvk = np.asarray(jcam.project_kb8(jnp.asarray(pts), *args, jnp.asarray(kb)))
    close(tcam.undistort_points_kb8(T(uvk), *args, T(kb)),
          jcam.undistort_points_kb8(jnp.asarray(uvk), *args, jnp.asarray(kb)),
          atol=1e-4)


def _two_views(rng, n=120, noise=0.3):
    K = np.array([[260, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, (n, 1))],
                       -1)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.02, -0.05, 0.01])), np.float64)
    t = np.array([-0.3, 0.05, 0.02])
    x1 = (X / X[:, 2:]) @ K.T
    Xc = X @ R.T + t
    x2 = (Xc / Xc[:, 2:]) @ K.T
    x1 = x1[:, :2] + rng.normal(0, noise, (n, 2))
    x2 = x2[:, :2] + rng.normal(0, noise, (n, 2))
    return K, R.astype(np.float32), t.astype(np.float32), \
        x1.astype(np.float32), x2.astype(np.float32)


def test_triangulate_batch(rng):
    K, R, t, x1, x2 = _two_views(rng)
    P1 = K @ np.eye(3, 4, dtype=np.float32)
    P2 = K @ np.concatenate([R, t[:, None]], 1)
    close(ttri.triangulate_batch(T(P1), T(P2), T(x1), T(x2)),
          jtri.triangulate_batch(jnp.asarray(P1), jnp.asarray(P2),
                                 jnp.asarray(x1), jnp.asarray(x2)),
          rtol=1e-4, atol=1e-4)


def test_epipolar_estimators(rng):
    """Well-conditioned (many-point) fits agree to f32; the Sampson GN
    refinement runs the same 12 damped steps."""
    K, R, t, x1, x2 = _two_views(rng, noise=0.2)
    Kinv = np.linalg.inv(K)
    x1n = (np.c_[x1, np.ones(len(x1))] @ Kinv.T)[:, :2].astype(np.float32)
    x2n = (np.c_[x2, np.ones(len(x2))] @ Kinv.T)[:, :2].astype(np.float32)
    w = (rng.random(len(x1)) < 0.9).astype(np.float32)
    Ej = jepi.eight_point_essential(jnp.asarray(x1n), jnp.asarray(x2n),
                                    jnp.asarray(w))
    Et = tepi.eight_point_essential(T(x1n), T(x2n), T(w))
    sign = np.sign(np.sum(np.asarray(Ej) * Et.numpy()))
    close(Et * sign, Ej, rtol=1e-4, atol=1e-4)
    # Sampson errors of near-inliers are ~1e-7 (normalized coords);
    # atol 1e-7 is 0.2% of the inlier threshold 3.841 / fx fy.
    close(tepi.sampson_error(Et, T(x1n), T(x2n)),
          jepi.sampson_error(Ej, jnp.asarray(x1n), jnp.asarray(x2n)),
          rtol=1e-3, atol=1e-7)
    Hj = jepi.homography_dlt(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w))
    Ht = tepi.homography_dlt(T(x1), T(x2), T(w))
    close(Ht, Hj, rtol=1e-4, atol=1e-4)
    close(tepi.homography_error(Ht, T(x1), T(x2)),
          jepi.homography_error(Hj, jnp.asarray(x1), jnp.asarray(x2)),
          rtol=1e-3, atol=1e-3)
    R0 = np.asarray(jse3.so3_exp(jnp.asarray([0.03, -0.04, 0.0])))
    t0 = np.array([-1.0, 0.3, 0.1], np.float32)
    Rj, tj = jepi.refine_rt_sampson(jnp.asarray(R0), jnp.asarray(t0),
                                    jnp.asarray(x1n), jnp.asarray(x2n),
                                    jnp.asarray(w))
    Rt, tt = tepi.refine_rt_sampson(T(R0), T(t0), T(x1n), T(x2n), T(w))
    # 12 damped GN steps from a distant start: the Jacobian sums' order
    # differs, so the pose agrees to 1e-4 (the init's pose bar).
    close(Rt, Rj, atol=1e-4)
    close(tt, tj, atol=1e-4)


def test_decompose_homography(rng):
    K, R, t, x1, x2 = _two_views(rng, noise=0.0)
    n = np.array([0.0, 0.0, 1.0], np.float32)
    H = K @ (R + np.outer(t, n) / 5.0) @ np.linalg.inv(K)
    H = (H / H[2, 2]).astype(np.float32)
    Rj, tj = jhom.decompose_homography(jnp.asarray(H), jnp.asarray(K))
    Rt, tt = thom.decompose_homography(T(H), T(K))
    close(Rt, Rj, atol=1e-4)
    close(tt, tj, atol=1e-4)
