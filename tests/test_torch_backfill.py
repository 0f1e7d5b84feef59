"""The init backfill and the young-map scale-collapse probe of the port
against the JAX package on the CPU, at the small configuration of
test_torch_system.py with the JAX package's default tracking options
(loop closing off).

The backfill bundle is compared from the JAX System's own commit state
(pose 1e-4 and inliers +-2, as for one tracking step: the same f32
formulas summed in another order). The collapse path is driven on both
Systems with ``init_collapse_frac = 1e9``, so every probe fails until
the reset budget is spent. Over a whole run, every pose reaches the
consumer once: live, late (backfill) or at shutdown."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.frame import Frame as TFrame
from send_slam_tpu_torch.models.map_state import map_from_numpy
from send_slam_tpu_torch.ops.orb import FrameFeatures as TFF

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

N_FRAMES = 50


def default_cfg(C, **tr):
    """The small configuration, default tracking options, loop closing
    off (the port refuses it)."""
    from test_torch_system import engine_cfg
    cfg = engine_cfg(C)
    return cfg.replace(tracking=dataclasses.replace(
        C.TrackingConfig(init_min_matches=40, loop_min_gap_kf=10 ** 6),
        **tr))


@pytest.fixture(scope="module")
def seq():
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=N_FRAMES)
    imgs = [np.round(w.render(Rs[k], tls[k])).astype(np.uint8)
            for k in range(N_FRAMES)]
    return ts, imgs


def to_port_frames(fb, n):
    """The first n rows of a stacked JAX Frame -> port Frames."""
    f = jax.tree_util.tree_map(np.array, fb)
    out = []
    for i in range(n):
        feat = {k: torch.from_numpy(np.array(v[i]))
                for k, v in f.feat._asdict().items()}
        feat["desc"] = torch.from_numpy(
            np.array(f.feat.desc[i]).view(np.int32))
        out.append(TFrame(TFF(**feat), torch.from_numpy(f.uv_und[i]),
                          torch.tensor(f.timestamp[i])))
    return out


def run(s, ts, imgs, n=N_FRAMES):
    """Feed n frames and drain at shutdown, as bench.py counts: the
    outputs, and every (timestamp, position) a consumer receives."""
    outs, got = [], []
    for k in range(n):
        out = s.track_monocular(imgs[k], float(ts[k]))
        outs.append(out)
    final = s.shutdown()
    for i, out in enumerate(outs + final):
        live = out.tracking_state == tsys.TRACKING_OK
        if live:
            assert out.position is not None
        repeat = i > 0 and out is (outs + final)[i - 1]
        if repeat:
            assert not out.backfill
        if live and not repeat:
            got.append((out.timestamp, out.position))
        got.extend((b[0], b[1]) for b in out.backfill)
    return outs, got


def test_backfill_step_from_jax_commit(seq):
    ts, imgs = seq
    s = JSystem(default_cfg(jc))
    calls = []
    orig = s._backfill_step

    def spy(m, R, t, alphas, frames):
        out = orig(m, R, t, alphas, frames)
        calls.append((m, R, t, alphas, frames, out))
        return out

    s._backfill_step = spy
    k = 0
    while not calls:
        s.track_monocular(imgs[k], float(ts[k]))
        k += 1
    m, R, t, alphas, frames, bundle = calls[0]
    n = int((np.asarray(alphas) > 0).sum())
    assert n >= 2
    port = tsys.System(default_cfg(tc), device="cpu")
    got = port._backfill_step(
        map_from_numpy({f: np.array(v) for f, v in m._asdict().items()},
                       device="cpu"),
        torch.from_numpy(np.array(R)), torch.from_numpy(np.array(t)),
        torch.from_numpy(np.array(alphas[:n])), to_port_frames(frames, n))
    want = np.asarray(bundle)[:n]
    assert got.shape == (n, 8)
    np.testing.assert_allclose(got[:, :7].numpy(), want[:, :7], atol=1e-4)
    assert np.abs(got[:, 7].numpy() - want[:, 7]).max() <= 2
    assert (want[:, 7] >= port.cfg.tracking.min_track_matches).all()


def test_collapse_resets_then_tracks(seq):
    ts, imgs = seq
    js = JSystem(default_cfg(jc, init_collapse_frac=1e9))
    for k in range(N_FRAMES):
        js.track_monocular(imgs[k], float(ts[k]))
    s = tsys.System(default_cfg(tc, init_collapse_frac=1e9), device="cpu")
    outs, got = run(s, ts, imgs)
    budget = s.cfg.tracking.init_collapse_max_resets
    assert js._collapse_resets == budget
    failed = [p for p in s.collapse_probes if not p[3]]
    assert s._collapse_resets == len(failed) == budget
    # Nothing of a discarded map reaches the consumer: every pose is of
    # the final map, whose first keyframe is its init reference.
    kf0_ts = s._kf_trajectory[0][0]
    assert got and min(t for t, _ in got) > kf0_ts
    first_ok = next(i for i, o in enumerate(outs)
                    if o.tracking_state == tsys.TRACKING_OK)
    assert outs[first_ok].timestamp >= kf0_ts
    assert sum(o.tracking_state == tsys.TRACKING_OK for o in outs) >= 3
    assert len(got) == len(s.trajectory())


def test_default_config_counts_every_frame_once(seq):
    ts, imgs = seq
    s = tsys.System(default_cfg(tc), device="cpu")
    outs, got = run(s, ts, imgs)
    stamps = [t for t, _ in got]
    assert len(stamps) == len(set(stamps)), "a timestamp was emitted twice"
    assert set(stamps) <= {float(t) for t in ts}
    assert sorted(stamps) == sorted(t for t, _, _ in s.trajectory())
    assert len(stamps) >= 30, len(stamps)
    assert any(o.backfill for o in outs)
    assert s.frames_extracted >= N_FRAMES
    assert s.shutdown() == []


def test_shutdown_flushes_held_poses(seq):
    """A sequence that ends while the probe is pending: the held poses
    (the commit frame and its backfill) come out at shutdown."""
    ts, imgs = seq
    s = tsys.System(default_cfg(tc), device="cpu")
    k = 0
    while not s._collapse_active:
        out = s.track_monocular(imgs[k], float(ts[k]))
        k += 1
    assert out.tracking_state == tsys.TRACKING_NOT_INITIALIZED
    held = list(s._held_outputs)
    assert len(held) >= 2 and not s.trajectory()
    final = s.shutdown()
    assert final[-1].tracking_state == tsys.TRACKING_NOT_INITIALIZED
    assert [b[0] for b in final[-1].backfill] == [h[0] for h in held]
    assert [t for t, _, _ in s.trajectory()] == [h[0] for h in held]
