"""Synthetic-scene renderer for the port's smoke run and tests (numpy).

A copy of ``SyntheticWorld`` from the JAX package's
``send_slam_tpu/utils/synth.py`` (the port must not import that
package): a random 3-D point cloud rendered as shaded, anti-aliased
squares, with exact ground-truth camera trajectories: the bench arc and
its multi-lap version, whose return passes revisit mapped territory.
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
        # Per-blob shading direction: a linear intensity ramp across
        # each square makes blobs individually distinctive (uniform
        # identical squares alias ORB descriptors in a way real-world
        # texture does not, creating phantom match consensus).
        ang = rng.uniform(0, 2 * np.pi, size=n_points)
        self.grad_dir = np.stack([np.cos(ang), np.sin(ang)], -1)

    def K(self):
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1]], np.float32)

    def render(self, R, t):
        """Render the cloud from camera (R, t) (camera-from-world).

        Squares are splatted with analytic box-coverage anti-aliasing so
        sub-pixel camera motion produces sub-pixel image motion (an
        integer-quantized renderer makes visual odometry unobservable
        below 1 px and poisons the test)."""
        img = np.full((self.H, self.W), 20.0, np.float32)
        p = self.points @ R.T + t
        z = p[:, 2]
        order = np.argsort(-z)  # far first (painter's algorithm)
        for i in order:
            if z[i] < 0.5:
                continue
            u = self.fx * p[i, 0] / z[i] + self.cx
            v = self.fy * p[i, 1] / z[i] + self.cy
            s = max(2.0, self.size_at_1m[i] / z[i])
            lx, hx = u - s / 2, u + s / 2
            ly, hy = v - s / 2, v + s / 2
            x0, x1 = int(np.floor(lx)), int(np.ceil(hx))
            y0, y1 = int(np.floor(ly)), int(np.ceil(hy))
            if x1 < 0 or y1 < 0 or x0 >= self.W or y0 >= self.H:
                continue
            x0c, y0c = max(x0, 0), max(y0, 0)
            x1c, y1c = min(x1, self.W), min(y1, self.H)
            xs = np.arange(x0c, x1c)
            ys = np.arange(y0c, y1c)
            # Per-pixel overlap of [x, x+1) with [lx, hx).
            cov_x = np.clip(np.minimum(xs + 1, hx) - np.maximum(xs, lx), 0, 1)
            cov_y = np.clip(np.minimum(ys + 1, hy) - np.maximum(ys, ly), 0, 1)
            cov = cov_y[:, None] * cov_x[None, :]
            # Linear shading ramp across the blob (see __init__).
            gx, gy = self.grad_dir[i]
            rx = (xs[None, :] + 0.5 - u) / s
            ry = (ys[:, None] + 0.5 - v) / s
            ramp = np.clip(0.5 + gx * rx + gy * ry, 0.0, 1.0)
            shade = self.intensity[i] * (0.55 + 0.65 * ramp)
            patch = img[y0c:y1c, x0c:x1c]
            img[y0c:y1c, x0c:x1c] = (1 - cov) * patch + cov * np.clip(shade, 0, 255)
        return np.clip(img, 0, 255).astype(np.float32)

    def trajectory(self, n_frames=40, fps=30.0):
        """Sideways arc with slight yaw: (timestamps, R_list, t_list)
        camera-from-world; world is also cam0's frame at t=0."""
        from scipy.spatial.transform import Rotation
        ts, Rs, tls = [], [], []
        for k in range(n_frames):
            a = k / max(n_frames - 1, 1)
            # Camera center moves along +x, slight sinusoid in y/z.
            c = np.array([1.6 * a, 0.15 * np.sin(2 * np.pi * a),
                          0.3 * a])
            yaw = -0.12 * a
            Rwc = Rotation.from_euler("y", yaw).as_matrix()
            R = Rwc.T
            t = -R @ c
            ts.append(k / fps)
            Rs.append(R)
            tls.append(t)
        return np.asarray(ts), Rs, tls

    def trajectory_laps(self, n_frames=1000, fps=30.0, laps=4.0):
        """Multi-lap version of the bench arc: the arc parameter sweeps
        0 -> 1 -> 0 on a cosine profile (no velocity jump at the
        turnarounds) ``laps`` times, so every return pass revisits
        mapped territory."""
        from scipy.spatial.transform import Rotation
        ts, Rs, tls = [], [], []
        for k in range(n_frames):
            ph = laps * k / max(n_frames - 1, 1)
            a = 0.5 - 0.5 * np.cos(2 * np.pi * ph)
            c = np.array([1.6 * a, 0.15 * np.sin(2 * np.pi * a),
                          0.3 * a])
            yaw = -0.12 * a
            Rwc = Rotation.from_euler("y", yaw).as_matrix()
            R = Rwc.T
            t = -R @ c
            ts.append(k / fps)
            Rs.append(R)
            tls.append(t)
        return np.asarray(ts), Rs, tls
