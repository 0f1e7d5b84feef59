"""Map checkpoints of the port against the JAX package's
(``send_slam_tpu/io/map_io.py``): one file format, so a map saved by
either package loads in the other with every field and dtype equal; the
header's version is checked, an older file's missing fields take their
empty-map defaults at the header's capacities, ``ORBSLAM3_MAP_PATH``
names the directory, and a session resumed from a checkpoint on the
port's CPU path relocalizes against it (tests/test_map_io.py's
session)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.io import map_io as jio
from send_slam_tpu.models.map_state import MapState as JMap
from send_slam_tpu.models.map_state import empty_map as j_empty_map
from send_slam_tpu_torch.io import map_io as tio
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.map_state import MapState, map_to_numpy
from send_slam_tpu_torch.utils.synth import SyntheticWorld

torch.set_num_threads(1)

MK, ML, N = 6, 40, 16


def random_map(seed):
    """Every field of a (6, 40, 16) map filled from a seed, in the JAX
    package's dtypes."""
    rng = np.random.default_rng(seed)
    base = {f: np.array(v) for f, v in j_empty_map(
        jc.MapConfig(max_keyframes=MK, max_landmarks=ML), N)._asdict().items()}
    out = {}
    for f, v in base.items():
        if v.dtype == np.bool_:
            out[f] = rng.random(v.shape) < 0.5
        elif v.dtype == np.uint32:
            out[f] = rng.integers(0, 2 ** 32, v.shape, dtype=np.uint32)
        elif v.dtype.kind == "i":
            out[f] = rng.integers(-1, 1000, v.shape).astype(v.dtype)
        else:
            out[f] = rng.normal(size=v.shape).astype(v.dtype)
    return out


def assert_same(a, b):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def jax_np(m):
    return {f: np.asarray(v) for f, v in m._asdict().items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_save_port_load(tmp_path, seed):
    m = random_map(seed)
    path = jio.save_map(JMap(**{f: jnp.asarray(v) for f, v in m.items()}),
                        str(tmp_path / "j.npz"))
    got = tio.load_map(path, device="cpu")
    assert isinstance(got, MapState)
    assert_same(map_to_numpy(got), m)
    assert got.kf_desc.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_port_save_jax_load(tmp_path, seed):
    m = random_map(seed)
    from send_slam_tpu_torch.models.map_state import map_from_numpy
    path = tio.save_map(map_from_numpy(m, device="cpu"),
                        str(tmp_path / "t.npz"))
    assert_same(jax_np(jio.load_map(path)), m)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(["__header__"] + list(m))
        head = json.loads(bytes(data["__header__"]).decode())
    assert head == {"version": 2, "max_keyframes": MK, "max_landmarks": ML,
                    "n_keypoints": N}


def test_header_version_is_checked(tmp_path):
    m = random_map(2)
    path = str(tmp_path / "v3.npz")
    head = json.dumps({"version": 3, "max_keyframes": MK,
                       "max_landmarks": ML, "n_keypoints": N})
    np.savez_compressed(path, __header__=np.frombuffer(head.encode(),
                                                       np.uint8), **m)
    with pytest.raises(ValueError, match="unsupported map version 3"):
        tio.load_map(path, device="cpu")
    with pytest.raises(ValueError, match="unsupported map version 3"):
        jio.load_map(path)


@pytest.mark.parametrize("missing", [
    ("kf_chain_break",),
    ("kf_signature", "lm_normal", "lm_dist_min", "lm_dist_max",
     "lm_bit_votes", "lm_vote_count")])
def test_older_file_takes_defaults(tmp_path, missing):
    """A version-1 file without some fields loads in both packages with
    the same empty-map defaults at the header's capacities."""
    m = random_map(3)
    path = str(tmp_path / "v1.npz")
    head = json.dumps({"version": 1, "max_keyframes": MK,
                       "max_landmarks": ML, "n_keypoints": N})
    np.savez_compressed(path, __header__=np.frombuffer(head.encode(),
                                                       np.uint8),
                        **{f: v for f, v in m.items() if f not in missing})
    got = map_to_numpy(tio.load_map(path, device="cpu"))
    assert_same(got, jax_np(jio.load_map(path)))
    empty = jax_np(j_empty_map(jc.MapConfig(max_keyframes=MK,
                                            max_landmarks=ML), N))
    for f in m:
        np.testing.assert_array_equal(got[f], empty[f] if f in missing
                                      else m[f], err_msg=f)


def test_map_path_env(tmp_path, monkeypatch):
    monkeypatch.delenv(tio.ENV_VAR, raising=False)
    assert tio.default_map_path(str(tmp_path)) == jio.default_map_path(
        str(tmp_path)) == str(tmp_path / "priv" / "maps" / "map.npz")
    monkeypatch.setenv("ORBSLAM3_MAP_PATH", str(tmp_path / "env"))
    assert tio.default_map_path() == jio.default_map_path() \
        == str(tmp_path / "env" / "map.npz")
    from send_slam_tpu_torch.models.map_state import map_from_numpy
    m = random_map(4)
    written = tio.save_map(map_from_numpy(m, device="cpu"))
    assert written == str(tmp_path / "env" / "map.npz")
    assert_same(jax_np(jio.load_map()), m)
    assert_same(map_to_numpy(tio.load_map(device="cpu")), m)


def resume_cfg(max_keyframes=32):
    w = SyntheticWorld(n_points=600)
    return tc.EngineConfig(
        orb=tc.OrbConfig(n_features=512, n_levels=4),
        camera=tc.CameraConfig(width=w.W, height=w.H, fx=w.fx, fy=w.fy,
                               cx=w.cx, cy=w.cy),
        map=tc.MapConfig(max_keyframes=max_keyframes, max_landmarks=2048,
                         ba_window=4),
        tracking=tc.TrackingConfig(init_min_matches=50))


@pytest.fixture(scope="module")
def session1(tmp_path_factory):
    """tests/test_map_io.py's first session on the port's CPU path: its
    System and its saved map."""
    world = SyntheticWorld(n_points=600)
    ts, Rs, tls = world.trajectory(n_frames=24)
    s1 = tsys.System(resume_cfg(), device="cpu")
    for k in range(len(ts)):
        s1.track_monocular(world.render(Rs[k], tls[k]), float(ts[k]))
    assert int(s1.map.n_kf) >= 2
    path = s1.save_map(str(tmp_path_factory.mktemp("s1") / "map.npz"))
    return s1, path, world, Rs, tls


def test_session_resume_relocalizes(session1):
    """tests/test_map_io.py's session on the port's CPU path: session 2
    loads session 1's map, is LOST with its covisibility window
    refreshed, and relocalizes on mapped frames without initializing."""
    s1, path, world, Rs, tls = session1
    s2 = tsys.System(resume_cfg(), device="cpu")
    s2.load_map(path)
    assert s2.state == tsys.TRACKING_LOST
    assert s2._n_kf_host == s2._slots_used == int(s1.map.n_kf)
    for f in dataclasses.fields(MapState):
        assert getattr(s2.map, f.name).equal(getattr(s1.map, f.name)), f.name
    np.testing.assert_array_equal(
        s2._st.ba_window.numpy(), s2._covis_window(s2.map).numpy())
    states = []
    for k in (10, 11, 12):
        out = s2.track_monocular(world.render(Rs[k], tls[k]), 99.0 + k)
        states.append(out.tracking_state)
    assert tsys.TRACKING_OK in states, states
    assert int(s2.map.n_kf) == int(s1.map.n_kf)
    assert s2.init_attempts == 0


def test_load_keeps_the_file_capacities(session1):
    """A map whose capacities differ from the System's configuration is
    taken as it is, as the JAX package's load_map builds it at the
    header's capacities; the session relocalizes on it."""
    s1, path, world, Rs, tls = session1
    s2 = tsys.System(resume_cfg(max_keyframes=48), device="cpu")
    s2.load_map(path)
    assert s2.map.max_keyframes == s1.map.max_keyframes == 32
    assert s2._st.ba_window.shape == (4,)
    states = [s2.track_monocular(world.render(Rs[k], tls[k]),
                                 99.0 + k).tracking_state
              for k in (10, 11, 12)]
    assert tsys.TRACKING_OK in states, states
