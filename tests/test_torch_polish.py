"""The young and wide polish slices of the port against the JAX package
on the CPU, from a JAX System's carried map (the small configuration of
test_torch_system.py, 50 frames): the wide window's keyframe set, one
wide and one young slice with the large-correction flag, the
conditional chain rebase, and the ``ba_slice`` /
``wide_bundle_adjustment`` wrappers.

Window ids are integers chosen by a top-k over integer covisibility
masses, so they must be equal, ties included (lower slot first, as
``lax.top_k``). Poses and landmarks to 1e-3, as the BA tests use (the
Hessian blocks are summed in another order and the Levenberg step
amplifies it); the rebase flag exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.models import covisibility as jcov, local_ba as jba
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.models import covisibility as tcov, local_ba as tba
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.map_state import map_from_numpy, map_to_numpy

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

N_FRAMES = 50
GEOM = ("kf_R", "kf_t", "lm_pos", "lm_dist_min", "lm_dist_max")


@pytest.fixture(scope="module")
def carried():
    from test_torch_system import engine_cfg
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=N_FRAMES)
    s = JSystem(engine_cfg(jc))
    for k in range(N_FRAMES):
        s.track_monocular(np.round(w.render(Rs[k], tls[k])).astype(np.uint8),
                          float(ts[k]))
    assert int(s.map.n_kf) >= 5
    m_np = {f: np.array(v) for f, v in s.map._asdict().items()}
    st_np = {f: np.array(v) for f, v in s._st._asdict().items()}
    return s, tsys.System(engine_cfg(tc), device="cpu"), m_np, st_np


def tmap(m_np):
    return map_from_numpy(m_np, device="cpu")


def assert_geometry(mj, mt, atol=1e-3):
    a = {f: np.asarray(v) for f, v in mj._asdict().items()}
    b = map_to_numpy(mt)
    for f in GEOM:
        np.testing.assert_allclose(b[f], a[f], atol=atol, err_msg=f)
    assert (a["kf_obs_lm"] != b["kf_obs_lm"]).sum() <= 2


def tied(m_np):
    """The carried map with keyframes 0-3 given one observation row, so
    their covisibility masses with the recent set tie."""
    m = {k: v.copy() for k, v in m_np.items()}
    m["kf_obs_lm"][1:4] = m["kf_obs_lm"][0]
    return m


@pytest.mark.parametrize("W", [32, 6, 4])
@pytest.mark.parametrize("ties", [False, True])
def test_wide_window_ids(carried, W, ties):
    _, _, m_np, _ = carried
    m_np = tied(m_np) if ties else m_np
    mj = {k: jnp.asarray(v) for k, v in m_np.items()}
    from send_slam_tpu.models.map_state import MapState as JMap
    ij, vj = jcov.wide_window_ids(JMap(**mj), W)
    it, vt = tcov.wide_window_ids(tmap(m_np), W)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert it.dtype == torch.int32
    if ties and W == 4:
        # The cut falls inside the tied group: the lowest slots are kept.
        kept = [int(i) for i in it.numpy() if i < 4]
        assert 1 <= len(kept) < 4 and kept == list(range(len(kept)))


@pytest.mark.parametrize("kind", ["wide", "young"])
@pytest.mark.parametrize("prune", [False, True])
def test_polish_slice(carried, kind, prune):
    s, port, m_np, _ = carried
    lam = 1e-3
    mj, dRj, dtj, bigj = getattr(s, f"_{kind}_slice")(
        s.map, jnp.asarray(lam, jnp.float32), jnp.asarray(prune))
    mt, dRt, dtt, bigt = getattr(port, f"_{kind}_slice")(tmap(m_np), lam,
                                                         prune)
    assert_geometry(mj, mt)
    np.testing.assert_allclose(dRt.numpy(), np.asarray(dRj), atol=1e-3)
    np.testing.assert_allclose(dtt.numpy(), np.asarray(dtj), atol=1e-3)
    assert bool(bigt) == bool(bigj)
    moved = np.abs(np.asarray(mj.lm_pos) - m_np["lm_pos"]).max()
    assert moved > 1e-4


def test_polish_slice_flags_a_large_correction(carried):
    """Turn the newest keyframe by 2 degrees: the wide slice pulls it
    back, and the flag is set on both sides."""
    s, port, m_np, _ = carried
    m = {k: v.copy() for k, v in m_np.items()}
    cur = int(m["n_kf"]) - 1
    a = np.deg2rad(2.0)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]], np.float32)
    m["kf_R"][cur] = Rz @ m["kf_R"][cur]
    from send_slam_tpu.models.map_state import MapState as JMap
    mj0 = JMap(**{k: jnp.asarray(v) for k, v in m.items()})
    mj, _, _, bigj = s._wide_slice(mj0, jnp.asarray(1e-3, jnp.float32),
                                   jnp.asarray(False))
    mt, _, _, bigt = port._wide_slice(tmap(m), 1e-3, False)
    assert bool(bigj) and bool(bigt)
    assert_geometry(mj, mt)


@pytest.mark.parametrize("big", [False, True])
def test_rebase_st_cond(carried, big):
    s, port, m_np, st_np = carried
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    dR = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    dt = rng.normal(size=3).astype(np.float32)
    stj = s._rebase_st_cond(s._st, jnp.asarray(dR), jnp.asarray(dt),
                            jnp.asarray(big))
    stt = port._rebase_st_cond(tsys.loop_state_from_numpy(st_np, "cpu"),
                               torch.from_numpy(dR), torch.from_numpy(dt),
                               torch.tensor(big))
    got = tsys.loop_state_to_numpy(stt)
    for f, v in stj._asdict().items():
        assert got[f].dtype == np.asarray(v).dtype, f
        if big:
            np.testing.assert_allclose(got[f], np.asarray(v), atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], st_np[f], err_msg=f)
    if big:
        assert np.abs(got["R"] - st_np["R"]).max() > 0.1


def test_ba_slice_and_wide_bundle_adjustment(carried):
    s, port, m_np, _ = carried
    from send_slam_tpu.models.map_state import MapState as JMap
    mj0 = JMap(**{k: jnp.asarray(v) for k, v in m_np.items()})
    mt0 = tmap(m_np)
    Kj, Kt = s._K, port._K
    cfg_j, cfg_t = s.cfg.map, port.cfg.map
    ij, _ = jcov.covis_window_ids(mj0, cfg_j.ba_window)
    it, _ = tcov.covis_window_ids(mt0, cfg_t.ba_window)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    oj = jba.ba_slice(mj0, Kj, cfg_j, ij, jnp.asarray(2e-3, jnp.float32),
                      prune=True, n_fixed=1)
    ot = tba.ba_slice(mt0, Kt, cfg_t, it, 2e-3, prune=True, n_fixed=1)
    assert_geometry(oj, ot)
    oj = jba.wide_bundle_adjustment(mj0, Kj, cfg_j, max_window=8, iters=3)
    ot = tba.wide_bundle_adjustment(mt0, Kt, cfg_t, max_window=8, iters=3)
    assert_geometry(oj, ot)
