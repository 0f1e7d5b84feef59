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


def test_public_helpers(rng):
    """The JAX package's public helpers that the main path does not call:
    se3_identity, se3_apply, rotmat_from_quat, intrinsics_matrix,
    unproject, distort_kb8, project_kb8, at 1e-5."""
    for got, ref in zip(tse3.se3_identity(), jse3.se3_identity()):
        assert got.dtype == torch.float32
        close(got, ref)
    xi = rng.normal(size=(16, 6)).astype(np.float32) * 0.5
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    pts = rng.normal(size=(16, 3)).astype(np.float32) * 3
    close(tse3.se3_apply(T(np.asarray(Rj)), T(np.asarray(tj)), T(pts)),
          jse3.se3_apply(Rj, tj, jnp.asarray(pts)))
    q = rng.normal(size=(32, 4)).astype(np.float32)     # not unit
    close(tse3.rotmat_from_quat(T(q)), jse3.rotmat_from_quat(jnp.asarray(q)))
    close(tcam.intrinsics_matrix(260.0, 255.0, 160.5, 119.5),
          jcam.intrinsics_matrix(260.0, 255.0, 160.5, 119.5))
    args = (260.0, 255.0, 160.0, 120.0)
    uv = rng.uniform(0, 320, (64, 2)).astype(np.float32)
    close(tcam.unproject(T(uv), *args), jcam.unproject(jnp.asarray(uv), *args))
    xn = rng.uniform(-1.5, 1.5, (64, 2)).astype(np.float32)
    xn[0] = 0.0                                          # r = 0 branch
    kb = np.array([0.02, -0.01, 0.003, -0.001], np.float32)
    close(tcam.distort_kb8(T(xn), T(kb)),
          jcam.distort_kb8(jnp.asarray(xn), jnp.asarray(kb)))
    cam_pts = np.concatenate([rng.uniform(-2, 2, (64, 2)),
                              rng.uniform(0.5, 8, (64, 1))],
                             -1).astype(np.float32)
    close(tcam.project_kb8(T(cam_pts), *args, T(kb)),
          jcam.project_kb8(jnp.asarray(cam_pts), *args, jnp.asarray(kb)))


def test_triangulate_dlt(rng):
    """One point at a time. The port's is triangulate_batch's float64
    solve (a named divergence since PR 11): it equals the JAX formula
    evaluated in float64 (numpy) to 1e-9 relative, and the JAX package's
    float32 solve to 1e-4 relative, that solve's own error on this
    low-parallax geometry (up to 2.5e-5 measured)."""
    K, R, t, x1, x2 = _two_views(rng, noise=0.0)
    P1 = K @ np.eye(3, 4, dtype=np.float32)
    P2 = K @ np.concatenate([R, t[:, None]], 1)

    def dlt64(P1, P2, a, b):
        P1, P2, a, b = (np.asarray(v, np.float64) for v in (P1, P2, a, b))
        A = np.stack([a[0] * P1[2] - P1[0], a[1] * P1[2] - P1[1],
                      b[0] * P2[2] - P2[0], b[1] * P2[2] - P2[1]])
        M, r = A[:, :3], -A[:, 3]
        return np.linalg.solve(M.T @ M + 1e-9 * np.eye(3), M.T @ r)

    for i in range(0, len(x1), 7):
        got = ttri.triangulate_dlt(T(P1), T(P2), T(x1[i]), T(x2[i]))
        assert got.shape == (3,) and got.dtype == torch.float32
        ref = dlt64(P1, P2, x1[i], x2[i])
        np.testing.assert_allclose(
            ttri.triangulate_dlt(*(torch.from_numpy(np.asarray(v, np.float64))
                                   for v in (P1, P2, x1[i], x2[i]))).numpy(),
            ref, rtol=1e-9, atol=0)
        jax_ref = np.asarray(jtri.triangulate_dlt(
            jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(x1[i]),
            jnp.asarray(x2[i])))
        close(got, jax_ref, rtol=1e-4, atol=1e-4 * np.abs(jax_ref).max())


def test_eight_point_fundamental(rng):
    """The normalized 8-point F (rank 2, f33 = 1) on a many-point fit,
    unweighted and weighted: within 1e-5 of F's largest entry."""
    K, R, t, x1, x2 = _two_views(rng, noise=0.2)
    w = (rng.random(len(x1)) < 0.9).astype(np.float32)
    for wt, wj in ((None, None), (T(w), jnp.asarray(w))):
        Fj = np.asarray(jepi.eight_point_fundamental(
            jnp.asarray(x1), jnp.asarray(x2), wj))
        Ft = tepi.eight_point_fundamental(T(x1), T(x2), wt)
        close(Ft, Fj, rtol=1e-5, atol=1e-5 * np.abs(Fj).max())
        assert abs(float(Ft[2, 2]) - 1.0) < 1e-6
        assert abs(float(torch.linalg.det(Ft.double()))) < 1e-9


def test_geometry_package_exports():
    """The port's geometry package exports the JAX package's names."""
    import send_slam_tpu.geometry as jg
    import send_slam_tpu_torch.geometry as tg
    names = {n for n in dir(jg) if not n.startswith("_")} - {
        "camera", "epipolar", "homography", "se3", "sim3", "triangulate"}
    assert names and names <= set(dir(tg))
    for n in names:
        assert callable(getattr(tg, n)), n
