"""Zhang camera calibration: closed-form intrinsics from homographies +
Levenberg-Marquardt bundle refinement.

The port's counterpart of ``send_slam_tpu/calib/zhang.py``. The linear
initialization (homographies, the B-matrix solve, extrinsics recovery)
stays host float64 numpy, copied; the nonlinear refinement over (fx, fy,
cx, cy, k1, k2, p1, p2, k3, per-view rvec/tvec) runs on the device in
float32 with a forward-mode Jacobian (``torch.func.jacfwd``, as the JAX
package uses ``jax.jacfwd``) and the same damping schedule.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.geometry.se3 import so3_exp


def make_object_points(pattern: Tuple[int, int], square_size: float) -> np.ndarray:
    """Planar board lattice (cols, rows) -> (N, 3), z=0, row-major
    (matches the reference's 25 mm grid, camera_calibrator.ex:258-268)."""
    cols, rows = pattern
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = np.stack([xs.reshape(-1), ys.reshape(-1),
                    np.zeros(cols * rows)], -1)
    return (pts * square_size).astype(np.float64)


def _homography_np(obj_xy: np.ndarray, img: np.ndarray) -> np.ndarray:
    """Plain DLT homography in f64 (host)."""
    def normalize(x):
        mean = x.mean(0)
        scale = np.sqrt(2) / max(np.mean(np.linalg.norm(x - mean, axis=1)), 1e-12)
        T = np.array([[scale, 0, -scale * mean[0]],
                      [0, scale, -scale * mean[1]],
                      [0, 0, 1]])
        return (x - mean) * scale, T

    x1, T1 = normalize(obj_xy)
    x2, T2 = normalize(img)
    n = len(x1)
    A = np.zeros((2 * n, 9))
    A[0::2, 3:5] = -x1
    A[0::2, 5] = -1
    A[0::2, 6:8] = x2[:, 1:2] * x1
    A[0::2, 8] = x2[:, 1]
    A[1::2, 0:2] = x1
    A[1::2, 2] = 1
    A[1::2, 6:8] = -x2[:, 0:1] * x1
    A[1::2, 8] = -x2[:, 0]
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(T2) @ H @ T1
    return H / H[2, 2]


def _zhang_intrinsics(Hs: List[np.ndarray]) -> np.ndarray:
    """Closed-form K from >= 3 homographies (Zhang 2000, Sec. 3.1)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.asarray(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 ** 2)
    lam = b33 - (b13 ** 2 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 ** 2)))
    cx = -b13 * fx ** 2 / lam
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def _extrinsics_from_h(K: np.ndarray, H: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * Kinv @ h1
    r2 = lam * Kinv @ h2
    r3 = np.cross(r1, r2)
    t = lam * Kinv @ h3
    if t[2] < 0:  # board must be in front of the camera
        r1, r2, t = -r1, -r2, -t
        r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], 1)
    # Orthonormalize.
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    # Rotation vector.
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R).as_rotvec(), t


def _residuals(params: torch.Tensor, obj_pts: torch.Tensor,
               img_pts: torch.Tensor) -> torch.Tensor:
    """params: (9 + 6V,) = [fx fy cx cy k1 k2 p1 p2 k3, (rvec tvec)*V].
    Returns (V, N, 2) residuals."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    V = obj_pts.shape[0]
    ext = params[9:].reshape(V, 6)
    Rm = so3_exp(ext[:, :3])                     # (V,3,3)
    t = ext[:, 3:]
    p = torch.einsum('vij,vnj->vni', Rm, obj_pts) + t[:, None, :]
    z = torch.clamp(p[..., 2], min=1e-9)
    x = p[..., 0] / z
    y = p[..., 1] / z
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    u = fx * xd + cx
    v = fy * yd + cy
    return torch.stack([u, v], -1) - img_pts


def _lm_refine(params0: torch.Tensor, obj_pts: torch.Tensor,
               img_pts: torch.Tensor, iters: int = 30,
               fix_k3: bool = False):
    """``iters`` damped Gauss-Newton steps, each kept only if it lowers
    the cost (the damping halves then, else quadruples). Runs on the
    device of its inputs without a host read."""
    def flat_res(p):
        return _residuals(p, obj_pts, img_pts).reshape(-1)

    jac = torch.func.jacfwd(flat_res)
    params = params0
    lam = torch.tensor(1e-3, dtype=torch.float32, device=params0.device)
    for _ in range(iters):
        r = flat_res(params)
        J = jac(params)                          # (M, P)
        if fix_k3:
            J[:, 8] = 0.0
        JtJ = J.T @ J
        Jtr = J.T @ r
        A = JtJ + lam * torch.diag(torch.clamp(torch.diagonal(JtJ), min=1e-8))
        delta = -torch.linalg.solve(A, Jtr[:, None])[:, 0]
        new_params = params + delta
        new_cost = torch.sum(flat_res(new_params) ** 2)
        cost = torch.sum(r ** 2)
        improved = new_cost < cost
        params = torch.where(improved, new_params, params)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    res = _residuals(params, obj_pts, img_pts)
    rms = torch.sqrt(torch.mean(torch.sum(res ** 2, -1)))
    return params, rms


def calibrate_camera(
    object_points: np.ndarray,     # (V, N, 3) board points (z=0)
    image_points: np.ndarray,      # (V, N, 2) detected corners
    iters: int = 30,
    fix_k3: bool = False,
    device=None,
) -> Dict:
    """Full Zhang pipeline, its refinement on ``device`` (default the
    card). Returns the reference's calibration dict: camera_matrix
    (3,3), distortion_coeffs (1,5) [k1 k2 p1 p2 k3], reprojection_error
    (RMS px), successful_frames, and the refined extrinsics (V, 6)."""
    dev = resolve_device(device)
    Vn = len(object_points)
    if Vn < 3:
        raise ValueError("need >= 3 views for Zhang initialization")

    Hs = [_homography_np(object_points[i][:, :2], image_points[i])
          for i in range(Vn)]
    K0 = _zhang_intrinsics(Hs)
    ext0 = []
    for H in Hs:
        rvec, tvec = _extrinsics_from_h(K0, H)
        ext0.append(np.concatenate([rvec, tvec]))

    params0 = np.concatenate([
        [K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]],
        np.zeros(5),
        np.concatenate(ext0),
    ]).astype(np.float32)

    params, rms = _lm_refine(
        torch.as_tensor(params0, device=dev),
        torch.as_tensor(np.asarray(object_points, np.float32), device=dev),
        torch.as_tensor(np.asarray(image_points, np.float32), device=dev),
        iters=iters, fix_k3=fix_k3)
    params = params.cpu().numpy().astype(np.float64)

    K = np.array([[params[0], 0, params[2]],
                  [0, params[1], params[3]],
                  [0, 0, 1]])
    dist = params[4:9].reshape(1, 5)
    return {
        "camera_matrix": K,
        "distortion_coeffs": dist,
        "reprojection_error": float(rms),
        "successful_frames": Vn,
        "extrinsics": params[9:].reshape(Vn, 6),
    }
