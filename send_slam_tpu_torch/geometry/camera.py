"""Camera models: pinhole projection with radtan (k1 k2 p1 p2 k3)
distortion, and the radtan / Kannala-Brandt (fisheye) undistortion the
front end applies to keypoints, batched over leading dims.

Counterpart of ``send_slam_tpu/geometry/camera.py``; the same formulas in
the same order. ``dist`` is a (5,) or (4,) float32 tensor.
"""

from __future__ import annotations

import torch


def distort_radtan(xn, dist):
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], -1)


def project(points_cam, fx, fy, cx, cy, dist=None):
    """Camera-frame points (…,3) -> pixels (…,2); radtan if ``dist``."""
    z = torch.clamp(points_cam[..., 2], min=1e-6)
    xn = points_cam[..., :2] / z[..., None]
    if dist is not None:
        xn = distort_radtan(xn, dist)
    return torch.stack([fx * xn[..., 0] + cx, fy * xn[..., 1] + cy], -1)


def undistort_points_kb8(uv, fx, fy, cx, cy, dist, iters: int = 10):
    """Invert KB8 by Newton iteration on theta; pixels under pinhole K."""
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    theta_d = torch.sqrt((xd * xd).sum(-1))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
            - theta_d
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / torch.clamp(df, min=1e-9)
    r = torch.tan(theta)
    scale = r / torch.clamp(theta_d, min=1e-9)
    scale = torch.where(theta_d < 1e-9, torch.ones_like(scale), scale)
    xn = xd * scale[..., None]
    return torch.stack([fx * xn[..., 0] + cx, fy * xn[..., 1] + cy], -1)


def undistort_points(uv, fx, fy, cx, cy, dist, iters: int = 8):
    """Fixed-point inversion of radtan (like cv2.undistortPoints);
    returns pixel coordinates in the same K."""
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    xd = torch.stack([x0, y0], -1)
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial,
                          (xd[..., 1] - dy) / radial], -1)
    return torch.stack([fx * xn[..., 0] + cx, fy * xn[..., 1] + cy], -1)
