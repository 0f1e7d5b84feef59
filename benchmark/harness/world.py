"""The benchmark's scenes: a frozen copy of the port's ``SyntheticWorld``
(``send_slam_tpu_torch/utils/synth.py``), rendered through a camera's
pinhole and radtan model, and the lap every traffic mix replays.

The copy is the yardstick's own: a later change to the port's renderer
changes nothing here. ``SyntheticWorld.render`` does the port's
renderer's arithmetic (the pinhole camera at the image centre). ``render_radtan``
splats the same blobs at their distorted centres, so the front end's
undistortion has real work to do; with every distortion coefficient 0
and the principal point at the centre it gives the same bits as
``render``.
"""

from __future__ import annotations

import numpy as np


class SyntheticWorld:
    def __init__(self, n_points=600, seed=11, width=320, height=240,
                 fx=260.0, fy=260.0, near=3.0, far=10.0):
        rng = np.random.default_rng(seed)
        self.W, self.H = width, height
        self.fx, self.fy = fx, fy
        self.cx, self.cy = width / 2.0, height / 2.0
        # Points spread widely so they stay in view along the trajectory.
        self.points = rng.uniform(
            [-6, -4.5, near], [6, 4.5, far], size=(n_points, 3))
        self.intensity = rng.uniform(60, 255, size=n_points)
        # Blob angular size tracks the focal length so the rendered
        # feature scale is resolution-independent.
        self.size_at_1m = rng.uniform(8, 16, size=n_points) * (fx / 260.0)
        # Per-blob shading direction (distinctive blobs).
        ang = rng.uniform(0, 2 * np.pi, size=n_points)
        self.grad_dir = np.stack([np.cos(ang), np.sin(ang)], -1)

    def render(self, R, t):
        """Render the cloud from camera (R, t) (camera-from-world) through
        the pinhole camera (fx, fy) at the image centre."""
        p = self.points @ R.T + t
        z = p[:, 2]
        u = self.fx * p[:, 0] / z + self.cx
        v = self.fy * p[:, 1] / z + self.cy
        return self._splat(u, v, z)

    def render_radtan(self, R, t, fx, fy, cx, cy, dist):
        """Render through a pinhole (fx, fy, cx, cy) with radtan distortion
        ``dist`` = (k1, k2, p1, p2, k3): each blob is splatted, at its
        pinhole size, centred where the camera model puts its point."""
        k1, k2, p1, p2, k3 = (float(d) for d in dist)
        p = self.points @ R.T + t
        z = p[:, 2]
        x, y = p[:, 0] / z, p[:, 1] / z
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        # The pinhole term as render() computes it, plus the distortion's
        # displacement (exactly 0 without distortion).
        u = fx * p[:, 0] / z + cx + fx * (xd - x)
        v = fy * p[:, 1] / z + cy + fy * (yd - y)
        return self._splat(u, v, z)

    def _splat(self, u, v, z):
        """Shaded, anti-aliased squares at pixel centres (u, v), far first
        (painter's algorithm); analytic box coverage keeps sub-pixel
        camera motion visible."""
        img = np.full((self.H, self.W), 20.0, np.float32)
        order = np.argsort(-z)
        for i in order:
            if z[i] < 0.5:
                continue
            s = max(2.0, self.size_at_1m[i] / z[i])
            lx, hx = u[i] - s / 2, u[i] + s / 2
            ly, hy = v[i] - s / 2, v[i] + s / 2
            x0, x1 = int(np.floor(lx)), int(np.ceil(hx))
            y0, y1 = int(np.floor(ly)), int(np.ceil(hy))
            if x1 < 0 or y1 < 0 or x0 >= self.W or y0 >= self.H:
                continue
            x0c, y0c = max(x0, 0), max(y0, 0)
            x1c, y1c = min(x1, self.W), min(y1, self.H)
            xs = np.arange(x0c, x1c)
            ys = np.arange(y0c, y1c)
            cov_x = np.clip(np.minimum(xs + 1, hx) - np.maximum(xs, lx), 0, 1)
            cov_y = np.clip(np.minimum(ys + 1, hy) - np.maximum(ys, ly), 0, 1)
            cov = cov_y[:, None] * cov_x[None, :]
            gx, gy = self.grad_dir[i]
            rx = (xs[None, :] + 0.5 - u[i]) / s
            ry = (ys[:, None] + 0.5 - v[i]) / s
            ramp = np.clip(0.5 + gx * rx + gy * ry, 0.0, 1.0)
            shade = self.intensity[i] * (0.55 + 0.65 * ramp)
            patch = img[y0c:y1c, x0c:x1c]
            img[y0c:y1c, x0c:x1c] = ((1 - cov) * patch
                                     + cov * np.clip(shade, 0, 255))
        return np.clip(img, 0, 255).astype(np.float32)


def rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def lap_poses(lap_frames: int, path_scale: float):
    """One closed lap of the bench arc's multi-lap sweep (the port's
    ``trajectory_laps`` at one lap over ``lap_frames + 1`` frames, the last
    dropped so the lap closes): the arc parameter runs 0 -> 1 -> 0 on a
    cosine profile, the camera centre along (1.6 a, 0.15 sin 2 pi a,
    0.3 a) times ``path_scale``, with a yaw of -0.12 a. Returns (R (n, 3, 3) camera-from-world, t (n, 3),
    centres (n, 3))."""
    Rs, ts, cs = [], [], []
    for k in range(lap_frames):
        a = 0.5 - 0.5 * np.cos(2 * np.pi * k / lap_frames)
        c = path_scale * np.array([1.6 * a, 0.15 * np.sin(2 * np.pi * a),
                                   0.3 * a])
        R = rot_y(-0.12 * a).T
        Rs.append(R)
        ts.append(-R @ c)
        cs.append(c)
    return np.asarray(Rs), np.asarray(ts), np.asarray(cs)
