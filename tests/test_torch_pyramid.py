"""The pyramid at scales other than 1.2 and the settings loaders, the
port against the JAX package on the CPU.

At 1.2 the pyramid is the exact 6:5 resample (tests/test_torch_frontend.py
holds it bit for bit). At any other scale the JAX package resamples each
level from the one before with ``jax.image.resize(..., "linear")``
(antialiased). The port builds the same per-axis weight matrices
(``resize_weights``) and applies them as two f32 products. Inside its
jitted resize, XLA rounds the weights in its own way: the JAX package's
own columns sum to 1 only within 4.5e-6 (scale 1.3) and 6.6e-6 (1.5),
against a few ulps for the port's (read by
test_jax_resize_weights_drift). That error, times 255 on each of the two
axes, bounds how far the two packages' levels can part: LEVEL_TOL. The
port's products are held at the f32 bar, 1e-4, twice: given the JAX
package's own weights they take each JAX level to the next, and its
levels are within 1e-4 of the float64 evaluation of the same weights.
Because last-ulp level
differences flip FAST comparisons, the keypoint and descriptor bar runs
the port's front end on the JAX package's levels: keypoints exact and
descriptors bit-identical, as the ORB tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.io.protocol import TRACKING_OK as J_OK
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.ops import orb as jorb, pyramid as jpyr
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.ops import orb as torb, pyramid as tpyr

torch.set_num_threads(1)

LEVEL_TOL = 2.5e-3          # 255 x 4.5e-6 on each axis, rounded up
SCALES = (1.3, 1.5)


@pytest.fixture(scope="module")
def frame():
    w = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                       fy=520.0, seed=11)
    ts, Rs, tls = w.trajectory(n_frames=90)
    return np.round(w.render(Rs[45], tls[45])).astype(np.uint8).astype(
        np.float32)


def weights_f64(m, n):
    """jax.image.resize's linear weights (m -> n) in float64, from its
    f32 sample positions."""
    inv = 1.0 / (n / m)
    sample = ((np.arange(n) + 0.5) * np.float64(np.float32(inv))
              - 0.5).astype(np.float32).astype(np.float64)
    x = np.abs(sample[None, :] - np.arange(m)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    w = w / w.sum(0, keepdims=True)
    return np.where(((sample >= -0.5) & (sample <= m - 0.5))[None], w, 0.0)


def jax_weights(m, n):
    """The JAX package's own f32 resize weights (m -> n), read from
    ``jax.image.resize`` of the identity: each output is one weighted sum
    of exact zeros and a one."""
    return np.asarray(jax.image.resize(jnp.eye(m, dtype=jnp.float32),
                                       (n, m), method="linear")).T.copy()


@pytest.mark.parametrize("scale", SCALES)
def test_jax_resize_weights_drift(scale):
    """The reading behind LEVEL_TOL: the JAX package's weight columns
    drift from 1 far past the f32 bar once times 255, the port's only by
    a few ulps."""
    shapes = jpyr.level_shapes(480, 640, 8, scale)
    drift_j = drift_t = 0.0
    for (H, W), (h, w) in zip(shapes[:-1], shapes[1:]):
        for m, n in ((H, h), (W, w)):
            drift_j = max(drift_j, float(np.abs(
                jax_weights(m, n).astype(np.float64).sum(0) - 1.0).max()))
            drift_t = max(drift_t, float(np.abs(
                tpyr.resize_weights(m, n, "cpu").double().sum(0)
                - 1.0).max()))
    assert drift_t <= 2.5e-7
    assert 255.0 * drift_j > 1e-4
    # LEVEL_TOL is that drift on both axes, rounded up by under 10%.
    assert LEVEL_TOL <= 1.1 * 2 * 255.0 * drift_j


@pytest.mark.parametrize("scale", SCALES)
def test_levels_with_jax_weights(frame, scale, monkeypatch):
    """Given the JAX package's own weights, the port's resample takes
    each JAX level to the next within the f32 bar: the whole gap of
    test_levels_against_jax_and_float64 lies in the weights."""
    lj = [np.asarray(x) for x in
          jpyr.build_pyramid(jnp.asarray(frame), 8, scale)]
    monkeypatch.setattr(tpyr, "resize_weights",
                        lambda m, n, device: torch.from_numpy(
                            jax_weights(m, n)))
    for prev, nxt in zip(lj[:-1], lj[1:]):
        got = tpyr.resize_linear(torch.from_numpy(prev.copy()), nxt.shape)
        np.testing.assert_allclose(got.numpy(), nxt, atol=1e-4)


@pytest.mark.parametrize("scale", SCALES)
def test_level_shapes_match_jax(scale):
    for hw in ((480, 640), (240, 320), (121, 163)):
        assert tpyr.level_shapes(*hw, 8, scale) \
            == jpyr.level_shapes(*hw, 8, scale)


@pytest.mark.parametrize("scale", SCALES)
def test_levels_against_jax_and_float64(frame, scale):
    lj = jpyr.build_pyramid(jnp.asarray(frame), 8, scale)
    lt = tpyr.build_pyramid(torch.from_numpy(frame), 8, scale)
    assert [tuple(x.shape) for x in lt] == [x.shape for x in lj]
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=LEVEL_TOL)
    for prev, nxt in zip(lt[:-1], lt[1:]):
        (H, W), (h, w) = prev.shape, nxt.shape
        ref = weights_f64(H, h).T @ prev.double().numpy() @ weights_f64(W, w)
        np.testing.assert_allclose(nxt.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("m,n", [(480, 369), (640, 492), (320, 213),
                                 (7, 9), (100, 100)])
def test_resize_weights(m, n):
    w = tpyr.resize_weights(m, n, "cpu").numpy()
    assert w.shape == (m, n) and w.dtype == np.float32
    np.testing.assert_allclose(w, weights_f64(m, n), atol=1e-6)
    np.testing.assert_allclose(w.sum(0), 1.0, atol=3e-7)


def jax_levels_into_port(monkeypatch, levels):
    monkeypatch.setattr(torb, "build_pyramid",
                        lambda img, n, s: [torch.from_numpy(np.asarray(x))
                                           for x in levels])


@pytest.mark.parametrize("scale", SCALES)
def test_keypoints_and_descriptors_on_jax_levels(frame, scale, monkeypatch):
    cfg_j = jc.OrbConfig(n_features=1250, n_levels=8, scale_factor=scale)
    cfg_t = tc.OrbConfig(n_features=1250, n_levels=8, scale_factor=scale)
    assert cfg_t.per_level_features == cfg_j.per_level_features
    a = jorb.extract_orb(jnp.asarray(frame), cfg_j)
    jax_levels_into_port(monkeypatch,
                         jpyr.build_pyramid(jnp.asarray(frame), 8, scale))
    b = torb.extract_orb(torch.from_numpy(frame), cfg_t)
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    np.testing.assert_array_equal(b.octave.numpy(), np.asarray(a.octave))
    np.testing.assert_array_equal(b.response.numpy(), np.asarray(a.response))
    np.testing.assert_allclose(b.uv.numpy(), np.asarray(a.uv), atol=1e-4)
    valid = np.asarray(a.valid)
    np.testing.assert_array_equal(b.desc.numpy().view(np.uint32)[valid],
                                  np.asarray(a.desc)[valid])
    assert valid.sum() > 800


YAML = "\n".join([
    "%YAML:1.0", "---",
    "Camera.type: \"PinHole\"",
    "Camera1.fx: 517.3", "Camera1.fy: 516.5",
    "Camera1.cx: 318.6", "Camera1.cy: 255.3",
    "Camera1.k1: 0.26", "Camera1.k2: -0.95",
    "Camera1.p1: -0.005", "Camera1.p2: 0.0026",
    "Camera.width: 640", "Camera.height: 480",
    "Camera.fps: 30", "Camera.RGB: 1",
    "ORBextractor.nFeatures: 1250",
    "ORBextractor.scaleFactor: 1.2",
    "ORBextractor.nLevels: 8",
    "ORBextractor.iniThFAST: 20",
    "ORBextractor.minThFAST: 7",
])


def assert_configs_equal(t, j):
    for part in ("camera", "orb", "map", "tracking", "server"):
        assert getattr(t, part).__dict__ == getattr(j, part).__dict__, part
    assert (t.dtype, t.image_dtype) == (j.dtype, j.image_dtype)


@pytest.mark.parametrize("text", [
    YAML,
    # The older Camera.* names, another scale, no header, a bare string.
    "\n".join(["Camera.type: KannalaBrandt8", "Camera.fx: 400.5",
               "Camera.fy: 401", "Camera.cx: 320", "Camera.cy: 240",
               "Camera.k1: 0.01", "Camera.k3: -0.002",
               "Camera.width: 752", "Camera.height: 480",
               "ORBextractor.scaleFactor: 1.3", "ORBextractor.nLevels: 6"]),
    "%YAML:1.0\n---\n",
])
def test_from_orbslam_yaml_field_for_field(text, tmp_path):
    assert_configs_equal(tc.from_orbslam_yaml(text),
                         jc.from_orbslam_yaml(text))
    path = tmp_path / "settings.yaml"
    path.write_text(text)
    assert_configs_equal(tc.from_orbslam_yaml(str(path)),
                         jc.from_orbslam_yaml(str(path)))


def test_tum_fr1_config_field_for_field():
    assert_configs_equal(tc.tum_fr1_config(), jc.tum_fr1_config())


def small_cfg(C, scale):
    """tests/test_torch_system.py's configuration at ``scale``."""
    return C.EngineConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4, scale_factor=scale),
        camera=C.CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                              cx=160.0, cy=120.0),
        map=C.MapConfig(max_keyframes=32, max_landmarks=4096, ba_window=6),
        tracking=C.TrackingConfig(
            init_min_matches=40, init_collapse_frac=0.0, init_backfill=False,
            young_ba_at_kf=0, wide_ba_every_kf=0, loop_min_gap_kf=10 ** 6))


def test_system_at_scale_1_3_against_jax():
    """Both Systems over the first frames of tests/test_torch_system.py's
    scene at scale 1.3: they initialize on the same frame, track every
    frame after it, and their live poses agree to 1e-2 m (the two
    pyramids part at LEVEL_TOL, so keypoints may differ)."""
    n = 24
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=50)
    imgs = [np.round(w.render(Rs[k], tls[k])).astype(np.uint8)
            for k in range(n)]
    js = JSystem(small_cfg(jc, 1.3))
    ps = tsys.System(small_cfg(tc, 1.3), device="cpu")
    poses = {}
    for k in range(n):
        oj = js.track_monocular(imgs[k], float(ts[k]))
        ot = ps.track_monocular(imgs[k], float(ts[k]))
        assert (oj.tracking_state == J_OK) == (ot.tracking_state
                                               == tsys.TRACKING_OK), k
        if ot.tracking_state == tsys.TRACKING_OK:
            poses[k] = (oj.position, ot.position)
    assert js.init_commit_ts == ps.init_commit_ts
    assert len(poses) >= n - 10
    err = max(np.abs(np.asarray(a) - np.asarray(b)).max()
              for a, b in poses.values())
    assert err < 1e-2, err
    assert ps.frames_extracted == n
