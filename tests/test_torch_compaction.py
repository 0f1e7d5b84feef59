"""Keyframe-table compaction and the forced cull of the port against the
JAX package on the CPU.

``carried`` is a JAX System on tests/test_covisibility.py's long-session
arc at its configuration (a 10-keyframe table; the init probe, backfill,
polish and loop closing off to keep the run short), stopped after its
first compaction. Compaction and culling are gathers and masks, so every
field must be equal, floats included: on the carried map, on variants
with culling holes, a chain break and landmarks re-anchored by a cull,
and on tests/test_covisibility.py's hand-built case. The System's
``_maybe_compact`` runs on both packages from the carried state before
that compaction, with a loop probe, a weld probe, a consistency run and
a pending loop verdict planted: the map, the slot count, the cooldown,
the judged verdict and the dropped state must agree. The port's own
long session is marked slow, as its JAX twin is."""

from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.models import covisibility as jcov
from send_slam_tpu.models.map_state import MapState as JMap
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.models import covisibility as tcov
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.map_state import map_from_numpy, map_to_numpy

torch.set_num_threads(1)

MK = 10


def long_cfg(C, full=False):
    """tests/test_covisibility.py's long-session configuration; unless
    ``full``, with the features that session does not need turned off."""
    extra = {} if full else dict(
        init_collapse_frac=0.0, init_backfill=False, young_ba_at_kf=0,
        wide_ba_every_kf=0, loop_min_gap_kf=10 ** 6)
    return C.EngineConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4),
        camera=C.CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                              cx=160.0, cy=120.0),
        map=C.MapConfig(max_keyframes=MK, max_landmarks=2048, ba_window=4),
        tracking=C.TrackingConfig(init_min_matches=50, kf_max_interval=6,
                                  pipeline_depth=1, pipeline_stretch=1,
                                  **extra))


def arc(n_frames=140):
    """tests/test_covisibility.py's arc: (R, t) camera-from-world."""
    out = []
    for k in range(n_frames):
        a = k / (n_frames - 1)
        c = np.array([3.5 * a, 0.1 * np.sin(2 * np.pi * a), 0.5 * a])
        R = Rotation.from_euler("y", -0.3 * a).as_matrix().T
        out.append((R, -R @ c))
    return out


def jnp_map(m_np):
    return JMap(**{k: jnp.asarray(v) for k, v in m_np.items()})


def jax_np(m):
    return {f: np.array(v) for f, v in m._asdict().items()}


@pytest.fixture(scope="module")
def carried():
    """What a JAX System's ``_maybe_compact`` saw at its first
    compaction: the lagged n_kf, the cooldown, the map and the loop
    state."""
    w = SyntheticWorld(n_points=900)
    s = JSystem(long_cfg(jc))
    calls = []
    orig = s._maybe_compact

    def spy(n):
        calls.append(dict(n=n, cooldown=s._compact_cooldown,
                          map=jax_np(s.map),
                          st={f: np.array(v)
                              for f, v in s._st._asdict().items()}))
        orig(n)

    s._maybe_compact = spy
    for k, (R, t) in enumerate(arc()):
        s.track_monocular(np.round(w.render(R, t)).astype(np.uint8),
                          k / 30.0)
        first = [i for i, c in enumerate(calls)
                 if c["cooldown"] == 0 and c["n"] >= MK - 2]
        if first and len(calls) > first[0] + 2:
            return calls[first[0]]
    pytest.fail("the JAX session never compacted")


def variant(m_np, kind):
    """The carried map, or it with culling holes and re-anchored
    landmarks (the JAX forced cull), a chain break, or keyframes
    invalidated with their rows kept."""
    m = {k: v.copy() for k, v in m_np.items()}
    live = np.flatnonzero(m["kf_valid"][:int(m["n_kf"])])
    if kind == "carried":
        return m
    if kind == "break":
        m["kf_chain_break"][live[2]] = True
    if kind in ("culled", "break"):
        out, n = jcov.cull_redundant_keyframes(
            jnp_map(m), redundancy_th=0.0, keep_latest=1, max_cull=2)
        assert int(n) == 2
        m = jax_np(out)
        assert (m["lm_ref_kf"] != m_np["lm_ref_kf"]).any()
        return m
    m["kf_valid"][live[[1, 4]]] = False                 # "holes"
    return m


def assert_maps_equal(got, want):
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


KINDS = ["carried", "culled", "break", "holes"]


@pytest.mark.parametrize("kind", KINDS)
def test_compact_keyframes(carried, kind):
    m = variant(carried["map"], kind)
    mj, nj = jcov.compact_keyframes(jnp_map(m))
    mt, nt = tcov.compact_keyframes(map_from_numpy(m, device="cpu"))
    assert int(nt) == int(nj) and nt.dtype == torch.int32
    assert_maps_equal(map_to_numpy(mt), jax_np(mj))
    n = int(nj)
    assert n < MK and map_to_numpy(mt)["kf_valid"][:n].all()


@pytest.mark.parametrize("kind", KINDS)
def test_forced_cull(carried, kind):
    m = variant(carried["map"], kind)
    mj, nj = jcov.cull_redundant_keyframes(jnp_map(m), redundancy_th=0.0,
                                           keep_latest=3, max_cull=1)
    mt, nt = tsys.System._forced_cull_step(map_from_numpy(m, device="cpu"))
    assert int(nt) == int(nj) == 1
    assert_maps_equal(map_to_numpy(mt), jax_np(mj))


def test_compaction_packs_and_remaps():
    """tests/test_covisibility.py's hand-built case: KF2 culled, the
    table packed, old slot 3's landmarks re-referenced to slot 2."""
    from test_covisibility import TestKeyframeCulling
    m = TestKeyframeCulling()._redundant_setup()
    m = m._replace(lm_ref_kf=jnp.asarray(
        [3 if v else -1 for v in np.asarray(m.lm_valid)], jnp.int32))
    mj, _ = jcov.compact_keyframes(
        jcov.cull_redundant_keyframes(m, keep_latest=1)[0])
    t2, _ = tcov.cull_redundant_keyframes(map_from_numpy(jax_np(m), "cpu"),
                                          keep_latest=1)
    mt, n_valid = tcov.compact_keyframes(t2)
    got = map_to_numpy(mt)
    assert_maps_equal(got, jax_np(mj))
    assert int(n_valid) == 4
    assert got["kf_valid"][:4].all() and not got["kf_valid"][4:].any()
    assert np.all(np.diff(got["kf_timestamp"][:4]) > 0)
    assert np.all(got["lm_ref_kf"][got["lm_valid"]] == 2)
    assert 12 in set(got["kf_obs_lm"][2])


def _done(x):
    f = Future()
    f.set_result(x)
    return f


def _systems(carried):
    """A JAX and a port System on the carried state, each with a loop
    probe, a weld probe, a consistency run and a sane loop verdict
    pending."""
    js = JSystem(long_cfg(jc))
    ts = tsys.System(long_cfg(tc), device="cpu")
    js.map = jnp_map(carried["map"])
    js._st = js._st._replace(**{f: jnp.asarray(v)
                                for f, v in carried["st"].items()})
    ts.map = map_from_numpy(carried["map"], device="cpu")
    ts._st = tsys.loop_state_from_numpy(carried["st"], "cpu")
    n = int(carried["map"]["n_kf"])
    for s in (js, ts):
        s.state = tsys.TRACKING_OK
        s._n_kf_host, s._slots_used = 14, n
        s._loop_consistency = (3, 1)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    js._pending_loop = (n - 1, jnp.asarray([1, 2, 0]), _done(0.5), _done(1))
    js._pending_weld = (n - 1, [])
    js._pending_loop_sanity = dict(
        kf_slot=n - 1, cand_top=1, score=0.5, cand_prev=np.int32(1),
        m_pre=js.map, dR=jnp.asarray(eye), dt=jnp.asarray(zero),
        med_fut=_done((np.float32(1.0), np.float32(1.5))))
    ts._pending_loop = dict(kf_slot=n - 1, cands=torch.tensor([1, 2, 0]),
                            scores=torch.tensor([0.5, 0.4, 0.3]))
    ts._pending_weld = dict(kf_slot=n - 1, cands=[])
    ts._pending_loop_sanity = dict(
        kf_slot=n - 1, cand_sel=torch.tensor(1), cand_top=1, score=0.5,
        m_pre=ts.map, dR=torch.eye(3), dt=torch.zeros(3),
        med_b=torch.tensor(1.0), med_a=torch.tensor(1.5))
    return js, ts


def assert_systems_agree(js, ts):
    assert_maps_equal(map_to_numpy(ts.map), jax_np(js.map))
    np.testing.assert_array_equal(ts._st.ba_window.numpy(),
                                  np.asarray(js._st.ba_window))
    for a in ("_slots_used", "_n_kf_host", "_compact_cooldown",
              "_loop_consistency", "loop_attempts", "_polish_queue",
              "loops_closed", "_last_loop_nkf"):
        assert getattr(ts, a) == getattr(js, a), a
    for a in ("_pending_loop", "_pending_weld", "_pending_loop_sanity"):
        assert (getattr(ts, a) is None) == (getattr(js, a) is None), a


def test_maybe_compact_from_carried_state(carried):
    """At MK - 2 the pending verdict is judged first (sane: global
    polish queued, a closure counted), the table compacted, and, since
    compaction frees no slot here, one keyframe force-culled and the
    table compacted again; the probes, the consistency run and the
    window are reset. The cooldown then holds for kf_min_interval + 1
    drained frames, and below MK - 2 nothing happens."""
    js, ts = _systems(carried)
    n = carried["n"]
    assert n >= MK - 2 and carried["cooldown"] == 0
    n_valid = int(carried["map"]["kf_valid"].sum())
    assert n_valid >= MK - 2            # the forced cull is needed
    js._maybe_compact(n)
    ts._maybe_compact(n)
    assert_systems_agree(js, ts)
    assert ts._slots_used == n_valid - 1
    assert ts._pending_loop is ts._pending_weld is None
    assert ts._loop_consistency is None and ts._pending_loop_sanity is None
    assert ts.loops_closed == 1 and ts.loop_attempts[-1][3] is True
    assert [q[0] for q in ts._polish_queue] == ["global"] * 8
    cool = tc.TrackingConfig().kf_min_interval + 1
    assert ts._compact_cooldown == cool
    m_after = ts.map
    for _ in range(cool):
        js._maybe_compact(MK - 1)
        ts._maybe_compact(MK - 1)
        assert ts.map is m_after
        assert_systems_agree(js, ts)
    assert ts._compact_cooldown == 0
    ts._pending_loop = dict(kf_slot=0, cands=torch.tensor([0, 0, 0]),
                            scores=torch.zeros(3))
    ts._maybe_compact(MK - 3)
    assert ts.map is m_after and ts._pending_loop is not None


def test_maybe_compact_without_forced_cull(carried):
    """A table with two culling holes compacts without the forced cull."""
    m = variant(carried["map"], "holes")
    js, ts = _systems(dict(carried, map=m))
    ts._pending_loop_sanity = js._pending_loop_sanity = None
    js._maybe_compact(MK - 2)
    ts._maybe_compact(MK - 2)
    assert_systems_agree(js, ts)
    assert ts._slots_used == int(m["kf_valid"].sum()) < MK - 2


@pytest.mark.slow
def test_five_times_capacity_tracks_to_end_on_the_port():
    """tests/test_covisibility.py's long session on the port's CPU path:
    more keyframes than the table holds, compactions ran, and tracking
    holds to the end."""
    from send_slam_tpu_torch.utils.synth import SyntheticWorld as TWorld
    world = TWorld(n_points=900)
    s = tsys.System(long_cfg(tc, full=True), device="cpu")
    states = [s.track_monocular(world.render(R, t), k / 30.0).tracking_state
              for k, (R, t) in enumerate(arc())]
    assert s._n_kf_host > MK, s._n_kf_host
    assert s._slots_used < s._n_kf_host
    assert sum(st == tsys.TRACKING_OK for st in states) > 100
    assert states[-10:].count(tsys.TRACKING_OK) >= 7, states[-10:]
    assert states[-1] in (2, 3), states[-5:]
