"""Synthetic-scene renderers for the port's smoke run and tests (numpy).

A copy of ``send_slam_tpu/utils/synth.py`` (the port must not import
that package), rendering bit for bit as it does:

- ``SyntheticWorld``: a random 3-D point cloud rendered as shaded,
  anti-aliased squares, with exact ground-truth camera trajectories: the
  bench arc and its multi-lap version, whose return passes revisit mapped
  territory;
- ``TexturedWorld``: a room of value-noise textured planes ray-cast per
  pixel, with optional sensor noise, gain drift, blur, vignetting, a
  sweeping occluder, exposure steps, rolling shutter and foreground
  boxes. Its renders are stateful (the noise generator, the log-gain walk,
  the previous pose, the frame count), so two worlds of one seed render
  the same frames when called in the same order.

Beside them, the port's own ``pose_problem`` and ``segsum_problem``:
seeded inputs of the robust pose-only Gauss-Newton and of the order-fixed
segment sums, for holding their CUDA kernels against the plain versions.
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


def _value_noise_texture(size: int, rng: np.random.Generator,
                         octaves=(4, 8, 16, 32, 64, 128)) -> np.ndarray:
    """Multi-octave value-noise texture in [0, 255]: random coarse grids
    bilinearly upsampled and summed with 1/octave amplitudes — dense
    gradients at every scale, the photometric statistics point-sprite
    scenes lack (VERDICT round-1 weak #4)."""
    acc = np.zeros((size, size), np.float64)
    amp_total = 0.0
    for g in octaves:
        grid = rng.uniform(-1, 1, (g + 1, g + 1))
        # numpy bilinear upsample (cv2-free: bench imports this module).
        xs = np.linspace(0, g, size, endpoint=False)
        x0 = np.floor(xs).astype(int)
        fx_ = xs - x0
        row = grid[:, x0] * (1 - fx_) + grid[:, x0 + 1] * fx_   # (g+1, S)
        up = row[x0, :] * (1 - fx_[:, None]) + row[x0 + 1, :] * fx_[:, None]
        amp = 1.0 / np.sqrt(g)
        acc += amp * up
        amp_total += amp
    acc /= amp_total
    lo, hi = acc.min(), acc.max()
    return (15 + 225 * (acc - lo) / max(hi - lo, 1e-9)).astype(np.float32)


class TexturedWorld:
    """A room of textured planes rendered by exact per-pixel ray casting
    with bilinear texture sampling — real-image-like content (corners
    everywhere, repeated structure, smooth shading) with exact ground
    truth. Same interface as SyntheticWorld (render / trajectory / K).

    Planes: back wall (z = depth), floor and ceiling, two side walls —
    every view direction hits texture, like an indoor TUM-style scene.
    """

    def __init__(self, seed=3, width=640, height=480,
                 fx=520.0, fy=520.0, tex_size=768, depth=8.0,
                 half_w=5.0, half_h=3.5, noise_sigma=0.0,
                 gain_jitter=0.0, blur_sigma=0.0,
                 vignette=0.0, occluder=0.0,
                 exposure_step_every=0, exposure_step=0.25,
                 rolling_shutter=0.0, rs_bands=8, fg_boxes=0):
        rng = np.random.default_rng(seed)
        self.W, self.H = width, height
        self.fx, self.fy = fx, fy
        self.cx, self.cy = width / 2.0, height / 2.0
        # Photometric stress knobs (closest zero-egress proxy to real
        # video): per-frame sensor noise, auto-exposure-style gain
        # drift (bounded log-gain random walk advanced per render), and
        # optical blur. The SLAM front end must hold up under all
        # three — clean renders overfit BRIEF to exact intensities.
        self.noise_sigma = noise_sigma
        self.gain_jitter = gain_jitter
        self.blur_sigma = blur_sigma
        # Lens vignetting: relative intensity falloff at the image
        # corners (0 = off, 0.4 = corners 40% darker — typical cheap
        # optics). Static per session, like a real lens.
        self.vignette = vignette
        # Transient occluder: a featureless panel (a person / door
        # crossing the view) sweeping through the frame, covering
        # ``occluder`` of the image width. It crosses on a slow cycle,
        # fully absent between crossings — tracking must survive the
        # feature dropout and re-acquire (rolling occlusion schedule).
        # Crossings start at frame ``occluder_start`` so two-view
        # initialization happens on unobstructed frames (a real
        # operator also doesn't start mapping behind a person).
        self.occluder = occluder
        self.occluder_start = 30
        # Auto-exposure STEPS (vs. the gain_jitter random walk): every
        # ``exposure_step_every`` frames the AE controller "snaps" —
        # the log-gain jumps by +-exposure_step in one frame, then the
        # drift dynamics pull it back. Real AE does exactly this when
        # a bright/dark region enters the view; BRIEF comparisons are
        # invariant to pure gain, but FAST thresholds and the blur/
        # noise interaction are not.
        self.exposure_step_every = exposure_step_every
        self.exposure_step = exposure_step
        # Rolling shutter: fraction of the inter-frame motion spanned
        # by the readout (0 = global shutter, 1 = readout takes a full
        # frame interval). Rendered EXACTLY: the image is split into
        # rs_bands horizontal bands, each ray-cast from the camera
        # pose interpolated at its band's readout time between the
        # previous delivered pose and the current one (top rows read
        # earliest) — real skew/wobble, not a post-hoc shear.
        self.rolling_shutter = rolling_shutter
        self.rs_bands = rs_bands
        self._prev_Rt = None
        self._frame_no = 0
        self._log_gain = 0.0
        self._rng = rng
        self.tex = [_value_noise_texture(tex_size, rng)
                    for _ in range(5 + fg_boxes)]
        self.ts_ = tex_size
        d, hw, hh = depth, half_w, half_h
        # (p0, e1, e2, extent1, extent2): x = p0 + a*e1 + b*e2,
        # a in [-extent1, extent1], b in [-extent2, extent2].
        ex = np.array([1.0, 0, 0])
        ey = np.array([0, 1.0, 0])
        ez = np.array([0, 0, 1.0])
        self.planes = [
            (np.array([0, 0, d]), ex, ey, hw, hh),          # back wall
            (np.array([0, hh, d / 2]), ex, ez, hw, d),      # floor
            (np.array([0, -hh, d / 2]), ex, ez, hw, d),     # ceiling
            (np.array([hw, 0, d / 2]), ey, ez, hh, d),      # right wall
            (np.array([-hw, 0, d / 2]), ey, ez, hh, d),     # left wall
        ]
        # Foreground boxes: camera-facing textured panels at mid-depth
        # — PARALLAX DISCONTINUITIES. Their edges occlude/disocclude
        # background texture as the camera moves (the depth-edge
        # statistics real indoor scenes have and single-shell rooms
        # lack): corners detected ON the discontinuity sit at two
        # depths and must be rejected or resolved by the epipolar
        # gates, and matching must survive background features
        # appearing/vanishing behind the box.
        for _ in range(fg_boxes):
            bx = rng.uniform(-0.5 * hw, 0.5 * hw)
            by = rng.uniform(-0.4 * hh, 0.4 * hh)
            bz = rng.uniform(0.35 * d, 0.6 * d)
            self.planes.append(
                (np.array([bx, by, bz]), ex, ey,
                 rng.uniform(0.3, 0.7), rng.uniform(0.25, 0.5)))

    def K(self):
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1]], np.float32)

    def _sample(self, tex, a, b, e1_extent, e2_extent):
        """Bilinear texture lookup at plane coords (a, b)."""
        S = self.ts_
        u = (a / (2 * e1_extent) + 0.5) * (S - 2)
        v = (b / (2 * e2_extent) + 0.5) * (S - 2)
        u = np.clip(u, 0, S - 2)
        v = np.clip(v, 0, S - 2)
        u0 = np.floor(u).astype(int)
        v0 = np.floor(v).astype(int)
        fu, fv = u - u0, v - v0
        t00 = tex[v0, u0]
        t01 = tex[v0, u0 + 1]
        t10 = tex[v0 + 1, u0]
        t11 = tex[v0 + 1, u0 + 1]
        return (t00 * (1 - fu) * (1 - fv) + t01 * fu * (1 - fv)
                + t10 * (1 - fu) * fv + t11 * fu * fv)

    def _cast(self, R, t, row0, row1):
        """Exact ray-cast of rows [row0, row1) from pose (R, t);
        returns (row1-row0, W) f32."""
        nrow = row1 - row0
        c = -(R.T @ t).astype(np.float32)             # camera center, world
        Rwc = R.T.astype(np.float32)
        uu, vv = np.meshgrid(
            np.arange(self.W, dtype=np.float32) + 0.5,
            np.arange(row0, row1, dtype=np.float32) + 0.5)
        d_cam = np.stack([(uu - self.cx) / self.fx,
                          (vv - self.cy) / self.fy,
                          np.ones_like(uu)], -1)      # (nrow,W,3)
        d_w = (d_cam @ Rwc.T).reshape(-1, 3)          # (nrow*W,3)

        img = np.zeros(nrow * self.W, np.float32)
        best_s = np.full(nrow * self.W, np.inf, np.float32)
        for tex, (p0, e1, e2, x1, x2) in zip(self.tex, self.planes):
            n = np.cross(e1, e2).astype(np.float32)
            denom = d_w @ n                           # (nrow*W,)
            num = np.float32((p0 - c) @ n)
            with np.errstate(divide="ignore", invalid="ignore"):
                s = num / denom
            ok = (s > 0.2) & (s < best_s)
            idx = np.nonzero(ok)[0]
            if idx.size == 0:
                continue
            hit = c[None] + s[idx, None] * d_w[idx] - p0[None]
            a = hit @ e1.astype(np.float32)
            b = hit @ e2.astype(np.float32)
            inb = (np.abs(a) <= x1) & (np.abs(b) <= x2)
            idx = idx[inb]
            if idx.size == 0:
                continue
            img[idx] = self._sample(tex, a[inb], b[inb], x1, x2)
            best_s[idx] = s[idx]
        return img.reshape(nrow, self.W)

    def render(self, R, t):
        """Render from camera (R, t) (camera-from-world), f32 (H, W)."""
        rs = self.rolling_shutter
        if rs > 0 and self._prev_Rt is not None:
            # Rolling shutter: band b's rows are read at time
            # t_cur - readout*(1 - (b+.5)/B); interpolate the pose
            # between the previous delivered pose and the current one
            # (small inter-frame motion: linear blend of centers +
            # SVD-orthonormalized rotation blend is exact to O(dθ²)).
            R0, t0 = self._prev_Rt
            c0 = -(R0.T @ t0)
            c1 = -(R.T @ t)
            B = self.rs_bands
            bounds = np.linspace(0, self.H, B + 1).astype(int)
            rows = []
            for b in range(B):
                alpha = 1.0 - rs * (1.0 - (b + 0.5) / B)
                Rb_w = (1 - alpha) * R0.T + alpha * R.T
                U, _, Vt = np.linalg.svd(Rb_w)
                Rb_w = U @ Vt
                cb = (1 - alpha) * c0 + alpha * c1
                Rb = Rb_w.T
                tb = -Rb @ cb
                rows.append(self._cast(Rb, tb, bounds[b], bounds[b + 1]))
            img = np.concatenate(rows, axis=0)
        else:
            img = self._cast(R, t, 0, self.H)
        self._prev_Rt = (np.asarray(R, np.float64).copy(),
                         np.asarray(t, np.float64).copy())
        if self.occluder > 0 and self._frame_no >= self.occluder_start:
            # One crossing every 120 frames: the panel's center sweeps
            # x from -w/2 to W+w/2 over 40 frames, then absent for 80.
            ph = (self._frame_no - self.occluder_start) % 120
            if ph < 40:
                w_occ = self.occluder * self.W
                cx_occ = (ph / 39.0) * (self.W + w_occ) - w_occ / 2
                x0 = max(0, int(cx_occ - w_occ / 2))
                x1 = min(self.W, int(cx_occ + w_occ / 2))
                if x1 > x0:
                    # Near-featureless: flat with faint large-scale
                    # shading so it contributes no stable corners.
                    ramp = np.linspace(88.0, 112.0, x1 - x0,
                                       dtype=np.float32)
                    img[:, x0:x1] = ramp[None, :]
        self._frame_no += 1
        if self.vignette > 0:
            yy, xx = np.mgrid[0:self.H, 0:self.W].astype(np.float32)
            r2 = (((xx - self.cx) / self.cx) ** 2
                  + ((yy - self.cy) / self.cy) ** 2) / 2.0
            img = img * (1.0 - self.vignette * r2)
        if self.blur_sigma > 0:
            from scipy.ndimage import gaussian_filter
            img = gaussian_filter(img, self.blur_sigma)
        if self.exposure_step_every > 0 \
                and self._frame_no % self.exposure_step_every == 0 \
                and self._frame_no > self.occluder_start // 2:
            # AE snap: a one-frame log-gain jump (sign alternates so
            # the walk stays bounded); the drift dynamics below decay
            # it back over the following frames.
            sign = 1.0 if (self._frame_no // self.exposure_step_every) \
                % 2 == 0 else -1.0
            self._log_gain = float(np.clip(
                self._log_gain + sign * self.exposure_step, -0.45, 0.45))
        if self.gain_jitter > 0 or self.exposure_step_every > 0:
            self._log_gain = float(np.clip(
                0.95 * self._log_gain
                + self._rng.normal(0, max(self.gain_jitter, 1e-9)),
                -0.45, 0.45))
            img = img * np.exp(self._log_gain)
        if self.noise_sigma > 0:
            img = img + self._rng.normal(0, self.noise_sigma, img.shape)
        return np.clip(img, 0, 255).astype(np.float32)

    def trajectory(self, n_frames=40, fps=30.0):
        return SyntheticWorld.trajectory(self, n_frames=n_frames, fps=fps)

    def trajectory_laps(self, n_frames=1000, fps=30.0, laps=4.0):
        return SyntheticWorld.trajectory_laps(
            self, n_frames=n_frames, fps=fps, laps=laps)


def pose_problem(n: int, seed: int, *,
                 valid_frac: float = 0.9, outlier_frac: float = 0.15,
                 behind_frac: float = 0.0, flip: bool = False,
                 with_sigma2: bool = True) -> dict:
    """Inputs of ``pose_only_gn`` (numpy, float32; ``w_valid`` bool) at a
    640x480 camera with TUM fr1's pinhole: ``n`` points 1-5 m in front of
    the true pose, observed with noise inside 1.2 sigma (chi2 <= 1.44 at
    the true pose) or, for ``outlier_frac`` of them, moved 8-30 sigma
    (chi2 >= 64); sigma2 = 1.2^(2 octave) over octaves 0-7 (or None, and
    sigma 1 px for every point).
    ``behind_frac`` of the points lie 0.5-3 m behind the camera, still
    valid. The start pose is the true one moved by ~2 degrees and ~5 cm;
    ``flip`` turns it a further 180 degrees about the camera's y axis,
    which puts every point behind it."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 517.3, 516.5, 318.6, 255.3

    def rot(axis, ang):
        axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K

    R_true = rot(rng.normal(size=3), rng.uniform(0.05, 0.5))
    t_true = rng.uniform(-0.5, 0.5, 3)
    u = rng.uniform(0, 640, n)
    v = rng.uniform(0, 480, n)
    depth = rng.uniform(1.0, 5.0, n)
    behind = rng.random(n) < behind_frac
    depth[behind] = -rng.uniform(0.5, 3.0, int(behind.sum()))
    p_cam = np.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth], 1)
    X = (p_cam - t_true) @ R_true        # R^T (p - t), row by row
    octave = rng.integers(0, 8, n)
    sigma2 = 1.2 ** (2.0 * octave)
    sig = np.sqrt(sigma2) if with_sigma2 else np.ones(n)
    ang = rng.uniform(0, 2 * np.pi, n)
    outlier = rng.random(n) < outlier_frac
    rad = np.where(outlier, rng.uniform(8.0, 30.0, n),
                   1.2 * np.sqrt(rng.random(n))) * sig
    uv_obs = np.stack([u + rad * np.cos(ang), v + rad * np.sin(ang)], 1)
    dR = rot(rng.normal(size=3), np.deg2rad(2.0))
    R0 = dR @ R_true
    t0 = dR @ t_true + rng.normal(0, 0.05 / np.sqrt(3), 3)
    if flip:
        R0, t0 = rot([0, 1, 0], np.pi) @ R0, rot([0, 1, 0], np.pi) @ t0
    f32 = np.float32
    return dict(R0=R0.astype(f32), t0=t0.astype(f32), X=X.astype(f32),
                uv_obs=uv_obs.astype(f32),
                w_valid=rng.random(n) < valid_frac,
                sigma2=sigma2.astype(f32) if with_sigma2 else None,
                fx=fx, fy=fy, cx=cx, cy=cy,
                R_true=R_true.astype(f32), t_true=t_true.astype(f32))


# The segment sums' shapes on the main path (TUM1.yaml: N = 1,000
# keypoints, 16,384 landmark slots): a BA window of W keyframes, its
# valid observations (the rest are the spill slot) and the most
# keyframes that observe one landmark; and the pose graph over 256
# keyframe slots of which n_kf are live, with its 256 chain edges, 5
# covisibility edges a slot and the loop edge, as
# ``apply_loop_correction`` joins them (its longest block sums 257 rows).
SEGSUM_CASES = {
    "local_8": dict(W=8, N=1000, L=16384, n_valid=1000, max_obs=5),
    "local_8_steady": dict(W=8, N=1000, L=16384, n_valid=6000, max_obs=8),
    "wide_64": dict(W=64, N=1000, L=16384, n_valid=2000, max_obs=2),
    "global_256": dict(W=256, N=1000, L=16384, n_valid=2000, max_obs=2),
    "pose_graph": dict(MK=256, n_kf=15, top_k=5),
}


def segsum_values(rows: int, cols: int, seed: int) -> np.ndarray:
    """(rows, cols) float32 over twelve decades, signs mixed."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, cols))
            * 10.0 ** rng.uniform(-6, 6, (rows, 1))).astype(np.float32)


def segsum_problem(name: str, seed: int) -> dict:
    """Segment ids of a ``SEGSUM_CASES`` entry (numpy int64).

    A BA window: ``ids`` (W * N,), keyframe-major, in [-1, L]; a valid
    row holds a landmark slot, each landmark observed by 1..max_obs
    distinct keyframes at one keypoint each; invalid rows hold L (the
    spill slot), one in a hundred -1. The pose graph: ``h_seg`` (4 E,)
    over MK * MK blocks and ``b_seg`` (2 E,) over MK slots, as
    ``optimize_pose_graph`` builds them."""
    c = SEGSUM_CASES[name]
    rng = np.random.default_rng(seed)
    if "MK" in c:
        MK, n_kf, k = c["MK"], c["n_kf"], c["top_k"]
        slot = np.arange(MK)
        # The chain joins each slot to the last live one before it; a
        # dead slot's covisibility edges go to slots 0..k-1, where
        # ``stable_topk`` breaks the ties of an empty row.
        ci = np.clip(np.minimum(slot, n_kf) - 1, 0, None)
        ki = np.repeat(slot, k)
        kj = np.concatenate([
            (i + rng.choice(np.arange(1, n_kf), k, replace=False)) % n_kf
            if i < n_kf else np.arange(k) for i in slot])
        ii = np.concatenate([ci, ki, [n_kf - 1]])
        jj = np.concatenate([slot, kj, [0]])
        h_seg = np.concatenate([ii * MK + ii, jj * MK + jj, ii * MK + jj,
                                jj * MK + ii])
        return dict(h_seg=h_seg.astype(np.int64),
                    b_seg=np.concatenate([ii, jj]).astype(np.int64),
                    n_h=MK * MK, n_b=MK)
    W, N, L = c["W"], c["N"], c["L"]
    ids = np.full((W, N), L, np.int64)
    ids[rng.random((W, N)) < 0.01] = -1
    free = [list(rng.permutation(N)) for _ in range(W)]
    lms = rng.permutation(L)
    n, k = 0, 0
    while n < c["n_valid"]:
        n_obs = min(int(rng.integers(1, c["max_obs"] + 1)),
                    c["n_valid"] - n)
        for w in rng.choice(W, n_obs, replace=False):
            ids[w, free[w].pop()] = lms[k]
        n, k = n + n_obs, k + 1
    return dict(ids=ids.reshape(-1), L=L, W=W, N=N)
