"""The slice as a whole: the port's System against the JAX System on the
small engine configuration (320x240, 512 features, 4 levels, 32
keyframes, 4096 landmarks, BA window 6) with the features the slice
leaves out turned off on both sides.

The JAX System runs jitted, so its floats differ from eager arithmetic
in the last bits: one frame step from the JAX System's carried map and
loop state is compared with tolerances (pose 1e-4, inliers +-2, the
keyframe decision exactly)."""

import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.io.protocol import TRACKING_OK as J_OK
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.io.evaluate import ate_rmse
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.map_state import map_from_numpy

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

N_FRAMES = 50


def engine_cfg(C):
    return C.EngineConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4),
        camera=C.CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                              cx=160.0, cy=120.0),
        map=C.MapConfig(max_keyframes=32, max_landmarks=4096, ba_window=6),
        tracking=C.TrackingConfig(
            init_min_matches=40, init_collapse_frac=0.0, init_backfill=False,
            young_ba_at_kf=0, wide_ba_every_kf=0, loop_min_gap_kf=10 ** 6))


@pytest.fixture(scope="module")
def seq():
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=N_FRAMES)
    imgs = [np.round(w.render(Rs[k], tls[k])).astype(np.uint8)
            for k in range(N_FRAMES)]
    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])
    return ts, imgs, gt


@pytest.fixture(scope="module")
def jax_run(seq):
    """Run the JAX System over the sequence; at every 8th tracked frame,
    carry its map and loop state into the port and run one frame step
    on both from that state on the next image."""
    import jax.numpy as jnp
    ts, imgs, _ = seq
    s = JSystem(engine_cfg(jc))
    port = tsys.System(engine_cfg(tc), device="cpu")
    steps, n_ok = [], 0
    for k in range(N_FRAMES):
        out = s.track_monocular(imgs[k], float(ts[k]))
        n_ok += out.tracking_state == J_OK
        if (k + 1 < N_FRAMES and s.state == J_OK and int(s.map.n_kf) >= 2
                and n_ok % 8 == 1):
            m_np = {f: np.asarray(v) for f, v in s.map._asdict().items()}
            st_np = {f: np.asarray(v) for f, v in s._st._asdict().items()}
            ts_dev = float(ts[k + 1]) - s._t0
            _, stj, sj = s._frame_step(s.map, s._st, jnp.asarray(imgs[k + 1]),
                                       ts_dev, jnp.asarray(False))
            _, stt, st_ = port._frame_step(
                map_from_numpy(m_np, device="cpu"),
                tsys.loop_state_from_numpy(st_np, device="cpu"),
                imgs[k + 1], ts_dev)
            steps.append((np.asarray(sj), st_.numpy(), np.asarray(stj.R),
                          stt.R.numpy(), np.asarray(stj.t), stt.t.numpy()))
            back = tsys.loop_state_to_numpy(
                tsys.loop_state_from_numpy(st_np, device="cpu"))
            assert all(np.array_equal(back[f], st_np[f]) and
                       back[f].dtype == st_np[f].dtype for f in st_np)
    return n_ok, steps


def test_frame_step_from_carried_state(jax_run):
    _, steps = jax_run
    assert len(steps) >= 3
    for sj, st_, Rj, Rt, tj, tt in steps:
        np.testing.assert_allclose(Rt, Rj, atol=1e-4)
        np.testing.assert_allclose(tt, tj, atol=1e-4)
        assert abs(sj[tsys.S_INLIERS] - st_[tsys.S_INLIERS]) <= 2
        assert sj[tsys.S_KF] == st_[tsys.S_KF]
        assert sj[tsys.S_NKF] == st_[tsys.S_NKF]


def test_jax_system_tracks(jax_run):
    n_ok, _ = jax_run
    assert n_ok >= 40, n_ok


@pytest.fixture(scope="module")
def port_run(seq):
    ts, imgs, gt = seq
    s = tsys.System(engine_cfg(tc), device="cpu")
    poses = {}
    for k in range(N_FRAMES):
        out = s.track_monocular(imgs[k], float(ts[k]))
        if out.tracking_state == tsys.TRACKING_OK:
            poses.setdefault(out.timestamp, out.position)
    return s, poses


def test_port_system_tracks(port_run, seq):
    ts, _, gt = seq
    s, poses = port_run
    assert len(poses) >= 40, len(poses)
    assert s.frames_extracted == N_FRAMES
    est_ts = sorted(poses)
    ate = ate_rmse(est_ts, np.asarray([poses[t] for t in est_ts]), ts, gt)
    # A 10-seed bar belongs to the JAX sweep; one seed is one basin
    # sample, so this only guards against a broken path.
    assert np.isfinite(ate) and ate < 0.5, ate
    lines = s.keyframe_trajectory_tum().strip().splitlines()
    assert len(lines) >= 3 and all(len(l.split()) == 8 for l in lines)
    assert len(s.trajectory()) >= 40


def test_lost_transitions_and_young_map_reset(seq):
    """Featureless frames: a young map (<= 5 keyframes) resets to
    re-initialize; an older one goes RECENTLY_LOST, then LOST, and the
    next real frame relocalizes it, as it does the JAX System fed the
    same frames. The port's recovered pose is the JAX relocalization
    step's on the port's own map (1e-4, inliers +-2). The blank frames
    stay below the atlas patience: no map is frozen."""
    import jax
    import jax.numpy as jnp
    from send_slam_tpu.geometry.se3 import se3_inverse as jinv
    from send_slam_tpu.models.map_state import MapState as JMap
    from send_slam_tpu_torch.models.map_state import map_to_numpy
    ts, imgs, _ = seq
    blank = np.full_like(imgs[0], 20)
    s = tsys.System(engine_cfg(tc), device="cpu")
    k = 0
    while s.state != tsys.TRACKING_OK:
        s.track_monocular(imgs[k], float(ts[k]))
        k += 1
    states = [s.track_monocular(blank, float(ts[k] + 0.03 * i)).tracking_state
              for i in range(1, 5)]
    assert tsys.TRACKING_NO_IMAGES_YET in states or \
        s.state == tsys.TRACKING_NOT_INITIALIZED
    assert int(s.map.n_kf) == 0

    t_last = float(ts[-1])
    js = JSystem(engine_cfg(jc))
    s = tsys.System(engine_cfg(tc), device="cpu")
    for sys_ in (js, s):
        for k in range(N_FRAMES):
            sys_.track_monocular(imgs[k], float(ts[k]))
        assert int(sys_.map.n_kf) > 5
        states = [sys_.track_monocular(blank, t_last + 0.03 * i)
                  .tracking_state for i in range(1, 17)]
        assert tsys.TRACKING_RECENTLY_LOST in states
        assert states[-1] == tsys.TRACKING_LOST
        assert sys_._reloc_failures < sys_.cfg.tracking.atlas_reloc_patience
    m_lost = map_to_numpy(s.map)
    outs = [sys_.track_monocular(imgs[-1], t_last + 1.0) for sys_ in (js, s)]
    assert [o.tracking_state for o in outs] == [J_OK, tsys.TRACKING_OK]
    assert s.last_reloc["branch"] == "retrieval"
    jf = js._make_frame(jnp.asarray(imgs[-1], jnp.float32), t_last + 1.0
                        - s._t0)
    ref, _ = js._reloc_step(JMap(**{k: jnp.asarray(v)
                                    for k, v in m_lost.items()}),
                            jf, jax.random.PRNGKey(0))
    np.testing.assert_allclose(outs[1].position,
                               np.asarray(jinv(ref.R, ref.t)[1]), atol=1e-4)
    assert abs(outs[1].n_inliers - int(ref.n_inliers)) <= 2
    assert outs[1].n_inliers >= s.cfg.tracking.reloc_min_matches
