"""The atlas of the port against the JAX package on the CPU: the
cross-map retrieval candidate, the cross-map Sim(3) with the JAX
package's Gumbel draws injected, the weld, the freeze, and the System's
weld state machine under scripted scores.

Maps: tests/test_atlas.py's hand-built ones (with a variant whose
keyframes and landmarks do not all fit, so the stable most-found-first
order decides), and a carried pair, two snapshots of one session of the
port's CPU path on tests/test_covisibility.py's arc (10-keyframe table;
a session of the port, not of the JAX package, keeps this file short),
the newer as the active map, with free landmark slots filled so that
the weld overflows.

Tolerances: candidate ids exact, scores 1e-6; the Sim(3)'s verdict,
match count and inlier mask exact, s/R/t 1e-5 (the JAX package runs the
same draws through XLA's own reductions); the weld's integer and boolean
fields exact, its floats 1e-6. The port's own occlusion session is
marked slow, as its JAX twin is."""

import dataclasses
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.models import atlas as ja
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.models import atlas as ta
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.loop_closing import N_HYP
from send_slam_tpu_torch.models.map_state import map_from_numpy, map_to_numpy
from test_atlas import _map_with
from test_torch_compaction import arc, jax_np, jnp_map, long_cfg

torch.set_num_threads(1)

# The JAX side jitted, as the JAX System runs it (one compile per shape).
j_candidate = jax.jit(ja.best_cross_map_candidate)
j_weld = jax.jit(ja.weld_maps)
_J_TR = jc.TrackingConfig()
j_sim3 = jax.jit(lambda a, f, ka, kf, key: ja.cross_map_sim3(
    a, f, ka, kf, key, _J_TR, min_matches=_J_TR.loop_min_matches))


def hand_maps(kind):
    """(active, frozen) of tests/test_atlas.py's weld test, or with the
    active map's tables nearly full ("overflow": 2 of the 4 frozen
    keyframes and 8 of the 15 frozen landmarks fit, all found once)."""
    rng = np.random.default_rng(3)
    lmA = rng.uniform(-2, 2, (20, 3))
    lmB = rng.uniform(-2, 2, (15, 3))
    if kind == "overflow":
        return (jax_np(_map_with(14, rng.uniform(-2, 2, (120, 3)), seed=1)),
                jax_np(_map_with(4, lmB, seed=2)))
    return jax_np(_map_with(3, lmA, seed=1)), jax_np(_map_with(4, lmB, seed=2))


@pytest.fixture(scope="module")
def carried():
    """(active, frozen): a session's map at frame 36 and at frame 20, the
    active one's free landmark slots filled but for half the frozen map's
    landmark count."""
    w = SyntheticWorld(n_points=900)
    s = tsys.System(long_cfg(tc), device="cpu")
    snaps = {}
    for k, (R, t) in enumerate(arc()):
        s.track_monocular(np.round(w.render(R, t)).astype(np.uint8),
                          k / 30.0)
        if k in (20, 36):
            snaps[k] = map_to_numpy(s.map)
        if k == 36:
            break
    active, frozen = snaps[36], snaps[20]
    free = np.flatnonzero(~active["lm_valid"])
    active["lm_valid"][free[:len(free) - frozen["lm_valid"].sum() // 2]] = \
        True
    return active, frozen


def newest(m):
    return int(np.flatnonzero(m["kf_valid"][:int(m["n_kf"])])[-1])


def T(x):
    return torch.from_numpy(np.array(x))


def test_best_cross_map_candidate(carried):
    act, fz = hand_maps("plain")
    cases = [(fz, act["kf_signature"][1]), (act, fz["kf_signature"][2]),
             (carried[1], carried[0]["kf_signature"][newest(carried[0])]),
             # A frozen map with no valid keyframe: slot 0, score -1.
             (dict(fz, kf_valid=np.zeros_like(fz["kf_valid"])),
              act["kf_signature"][0])]
    for frozen, sig in cases:
        kj, sj = j_candidate(jnp_map(frozen), jnp.asarray(sig))
        kt, st = ta.best_cross_map_candidate(map_from_numpy(frozen, "cpu"),
                                             T(sig))
        assert int(kt) == int(kj) and kt.dtype == torch.int32
        np.testing.assert_allclose(float(st), float(sj), atol=1e-6)


def _sim3_both(active, frozen, ka, kf, seed):
    key = jax.random.PRNGKey(seed)
    N = active["kf_uv"].shape[1]
    cfg_t = tc.TrackingConfig()
    rj = j_sim3(jnp_map(active), jnp_map(frozen), jnp.asarray(ka, jnp.int32),
                jnp.asarray(kf, jnp.int32), key)
    noise = T(jax.random.gumbel(key, (N_HYP, N)))
    rt = ta.cross_map_sim3(map_from_numpy(active, "cpu"),
                           map_from_numpy(frozen, "cpu"), ka, kf, noise,
                           cfg_t, min_matches=cfg_t.loop_min_matches)
    return rj, rt


def assert_sim3_equal(rj, rt):
    assert bool(rt.ok) == bool(rj.ok)
    assert int(rt.n_matches) == int(rj.n_matches)
    np.testing.assert_array_equal(rt.sim3.inlier.numpy(),
                                  np.asarray(rj.sim3.inlier))
    for f in ("s", "R", "t"):
        np.testing.assert_allclose(getattr(rt.sim3, f).numpy(),
                                   np.asarray(getattr(rj.sim3, f)),
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cross_map_sim3_revisit(seed):
    """tests/test_atlas.py's revisit: the frozen map's landmarks under a
    known Sim(3) are the active map; verified, and s/R/t recovered."""
    fz = hand_maps("plain")[1]
    s, R, t = 1.3, Rotation.from_rotvec([0, 0.2, 0]).as_matrix(), \
        np.array([1.0, 0.0, -0.5])
    act = dict(fz, lm_pos=(s * fz["lm_pos"] @ R.T + t).astype(np.float32))
    rj, rt = _sim3_both(act, fz, 1, 1, seed)
    assert_sim3_equal(rj, rt)
    assert bool(rt.ok) and abs(float(rt.sim3.s) - s) < 1e-2


def test_cross_map_sim3_unrelated_and_carried(carried):
    act, fz = hand_maps("plain")
    rj, rt = _sim3_both(act, fz, 1, 1, 3)          # no shared descriptor
    assert_sim3_equal(rj, rt)
    assert not bool(rt.ok) and int(rt.n_matches) == 0
    act, fz = carried
    ka = newest(act)
    kf, _ = j_candidate(jnp_map(fz), jnp.asarray(act["kf_signature"][ka]))
    rj, rt = _sim3_both(act, fz, ka, int(kf), 4)
    assert_sim3_equal(rj, rt)
    assert int(rt.n_matches) >= 12


def assert_close_maps(got, want, tol=1e-6):
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        if want[f].dtype.kind == "f":
            np.testing.assert_allclose(got[f], want[f], rtol=tol, atol=tol,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("kind", ["plain", "overflow", "carried"])
def test_weld_maps(carried, kind):
    active, frozen = carried if kind == "carried" else hand_maps(kind)
    s = np.float32(1.7 if kind != "carried" else 0.9)
    R = Rotation.from_rotvec([0.1, 0.3, -0.2]).as_matrix().astype(np.float32)
    t = np.array([2.0, -1.0, 0.5], np.float32)
    mj, kj, lj = j_weld(jnp_map(active), jnp_map(frozen), jnp.asarray(s),
                        jnp.asarray(R), jnp.asarray(t))
    mt, kt, lt = ta.weld_maps(map_from_numpy(active, "cpu"),
                              map_from_numpy(frozen, "cpu"), T(s), T(R), T(t))
    assert (int(kt), int(lt)) == (int(kj), int(lj))
    assert kt.dtype == lt.dtype == torch.int32
    assert_close_maps(map_to_numpy(mt), jax_np(mj))
    n_fz_kf = int(frozen["kf_valid"][:int(frozen["n_kf"])].sum())
    n_fz_lm = int(frozen["lm_valid"].sum())
    if kind == "plain":
        assert (int(kt), int(lt)) == (4, 15)
    else:                                   # some do not fit
        assert int(kt) < n_fz_kf and int(lt) < n_fz_lm


def test_freeze_keeps_maps_and_drops_the_oldest():
    """Each freeze parks the active map in the atlas and starts afresh;
    beyond max_atlas_maps the oldest goes. The atlas, the welds done,
    the trajectories and the loop record survive, as in the JAX
    System."""
    from test_torch_system import engine_cfg

    def cfg(C):
        c = engine_cfg(C)
        return c.replace(tracking=dataclasses.replace(c.tracking,
                                                      max_atlas_maps=2))
    js, ts = JSystem(cfg(jc)), tsys.System(cfg(tc), device="cpu")
    maps = [map_from_numpy(m, "cpu") for m in hand_maps("plain")] \
        + [map_from_numpy(hand_maps("overflow")[0], "cpu")]
    for s in (js, ts):
        s._trajectory = [(0.0, np.zeros(3), np.zeros(4))]
        s.loop_attempts = [(1, 0, 0.5, None)]
        s.welds_done = 1
        s._t0 = 5.0
    for i, m in enumerate(maps):
        ts.map = m
        js.map = jnp_map(map_to_numpy(m))
        ts._pending_weld = dict(kf_slot=0, cands=[])
        js._freeze_to_atlas()
        ts._freeze_to_atlas()
        assert len(ts.atlas) == len(js.atlas) == min(i + 1, 2)
        assert ts.atlas[-1] is m
        assert int(ts.map.n_kf) == 0 and ts._pending_weld is None
    assert all(a is b for a, b in zip(ts.atlas, maps[1:]))
    for s in (js, ts):
        assert s.welds_done == 1 and len(s._trajectory) == 1
        assert s.loop_attempts == [(1, 0, 0.5, None)] and s._t0 == 5.0
        assert s.state == tsys.TRACKING_NO_IMAGES_YET
    for fj, ft in zip(js.atlas, ts.atlas):
        assert_close_maps(map_to_numpy(ft), jax_np(fj), 0.0)


# --- the System's weld state machine under scripted scores ---------------

def _done(x):
    f = Future()
    f.set_result(np.asarray(x))
    return f


class Pair:
    """A JAX System and a port System on tests/test_atlas.py's active
    map with frozen maps in their atlas, driven through one script: the
    weld probe's candidates and scores are injected where the keyframe
    insert would compute them; both verify with the same draws, and the
    verdict can be forced."""

    def __init__(self, n_frozen=1, verdict=True):
        def cfg(C):
            return C.EngineConfig(
                orb=C.OrbConfig(n_features=32, n_levels=4),
                camera=C.CameraConfig(width=320, height=240, fx=260.0,
                                      fy=260.0, cx=160.0, cy=120.0),
                map=C.MapConfig(max_keyframes=16, max_landmarks=128,
                                ba_window=4))
        act, fz = hand_maps("plain")
        rng = np.random.default_rng(9)
        others = [jax_np(_map_with(2, rng.uniform(-2, 2, (10, 3)), seed=5))]
        frozen = (others * n_frozen)[:n_frozen - 1] + [fz]
        s, R, t = 1.3, Rotation.from_rotvec([0, 0.2, 0]).as_matrix(), \
            np.array([1.0, 0.0, -0.5])
        # The active map revisits the frozen one's place: its keyframe 1
        # carries the frozen keyframe 1's descriptors and landmarks.
        for f in ("kf_desc", "kf_obs_lm", "kf_kp_valid", "kf_signature"):
            act[f][1] = fz[f][1]
        act["lm_pos"][:15] = (s * fz["lm_pos"][:15] @ R.T + t)
        self.js = JSystem(cfg(jc))
        self.ts = tsys.System(cfg(tc), device="cpu")
        self.js.map, self.ts.map = jnp_map(act), map_from_numpy(act, "cpu")
        self.js.atlas = [jnp_map(m) for m in frozen]
        self.ts.atlas = [map_from_numpy(m, "cpu") for m in frozen]
        for sy in (self.js, self.ts):
            sy.state = tsys.TRACKING_OK
            sy._n_kf_host = sy._slots_used = 3
        key = jax.random.PRNGKey(11)
        noise = T(jax.random.gumbel(key, (N_HYP, 32)))
        tr_j, tr_t = cfg(jc).tracking, cfg(tc).tracking
        self.draws = 0

        def j_sim3(a, f, ka, kf, _key):
            r = ja.cross_map_sim3(a, f, ka, kf, key, tr_j,
                                  min_matches=tr_j.loop_min_matches)
            return r._replace(ok=r.ok & verdict)

        def t_sim3(a, f, ka, kf, _noise):
            self.draws += 1
            r = ta.cross_map_sim3(a, f, ka, kf, noise, tr_t,
                                  min_matches=tr_t.loop_min_matches)
            return r._replace(ok=r.ok & verdict)

        self.js._atlas_sim3, self.ts._atlas_sim3 = j_sim3, t_sim3

    def probe(self, kf_slot, cands, scores):
        self.js._pending_weld = (kf_slot, [
            (jnp.asarray(c, jnp.int32), _done(np.float32(sc)))
            for c, sc in zip(cands, scores)])
        self.ts._pending_weld = dict(kf_slot=kf_slot, cands=[
            (torch.tensor(c, dtype=torch.int32), torch.tensor(sc))
            for c, sc in zip(cands, scores)])

    def step(self):
        """One drained frame's weld phase on both; the maps, counters,
        atlas sizes, queued polish and pending state must agree."""
        gen = self.ts._gen.get_state()
        self.js._maybe_weld()
        self.ts._maybe_weld()
        assert_close_maps(map_to_numpy(self.ts.map), jax_np(self.js.map))
        for a in ("_slots_used", "_n_kf_host", "welds_done", "_polish_queue",
                  "loop_attempts", "loops_closed"):
            assert getattr(self.ts, a) == getattr(self.js, a), a
        assert len(self.ts.atlas) == len(self.js.atlas)
        np.testing.assert_array_equal(self.ts._st.ba_window.numpy(),
                                      np.asarray(self.js._st.ba_window))
        for a in ("_pending_weld", "_pending_loop"):
            assert (getattr(self.ts, a) is None) == \
                (getattr(self.js, a) is None), a
        return not self.ts._gen.get_state().equal(gen)


def test_weld_below_the_score_bar_does_nothing():
    p = Pair()
    p.probe(1, [1], [0.35])
    m0 = p.ts.map
    assert not p.step()                     # no draw
    assert p.ts._pending_weld is None and p.ts.map is m0 and p.draws == 0


def test_weld_unverified_does_nothing():
    p = Pair(verdict=False)
    p.probe(1, [1], [0.8])
    assert p.step()                         # phase 1: one draw, dispatched
    assert p.ts._pending_weld is not None and p.draws == 1
    m0 = p.ts.map
    assert not p.step()                     # phase 2: the verdict
    assert p.ts.map is m0 and p.ts.welds_done == 0 and len(p.ts.atlas) == 1


def test_weld_verified_imports_the_best_map():
    """The best-scoring frozen map is verified; on the verdict a pending
    loop verdict is judged first, then the map is imported and popped
    from the atlas, the slot and keyframe counts follow the import, the
    global polish is queued, the loop probe dropped and the window
    refreshed."""
    p = Pair(n_frozen=2)
    p.probe(1, [0, 1], [0.5, 0.9])
    assert p.step()
    n_kf = int(p.ts.map.n_kf)
    for sy in (p.js, p.ts):
        sy._pending_loop = None
    p.js._pending_loop_sanity = dict(
        kf_slot=2, cand_top=0, score=0.6, cand_prev=np.int32(0),
        m_pre=p.js.map, dR=jnp.eye(3), dt=jnp.zeros(3),
        med_fut=_done((np.float32(1.0), np.float32(50.0))))
    p.ts._pending_loop_sanity = dict(
        kf_slot=2, cand_sel=torch.tensor(0), cand_top=0, score=0.6,
        m_pre=p.ts.map, dR=torch.eye(3), dt=torch.zeros(3),
        med_b=torch.tensor(1.0), med_a=torch.tensor(50.0))
    p.ts._pending_loop = dict(kf_slot=2, cands=torch.tensor([0, 0, 0]),
                              scores=torch.zeros(3))
    p.js._pending_loop = (2, jnp.zeros(3, jnp.int32), _done(0.0), _done(0))
    p.step()
    assert p.ts.loop_attempts == [(2, 0, 0.6, "rejected", None)]
    assert p.ts.welds_done == 1 and len(p.ts.atlas) == 1
    assert p.ts.atlas[0].n_kf.item() == 2   # the other map stays
    assert int(p.ts.map.n_kf) == n_kf + 4 == p.ts._slots_used
    assert p.ts._n_kf_host == n_kf + 4
    assert [q[0] for q in p.ts._polish_queue] == ["global"] * 8
    assert p.ts._pending_loop is None and p.ts._pending_loop_sanity is None


@pytest.mark.slow
def test_occlusion_starts_and_welds_map2_on_the_port():
    """tests/test_atlas.py's occlusion session on the port's CPU path:
    map 1 freezes, map 2 starts in region B and is welded to map 1 on
    the way back; tracking is alive at the end."""
    from send_slam_tpu_torch.utils.synth import SyntheticWorld as TWorld
    world = TWorld(n_points=1200)
    rng = np.random.default_rng(5)
    world.points = np.concatenate([
        rng.uniform([-6, -4.5, 3], [2, 4.5, 10], (600, 3)),
        rng.uniform([8, -4.5, 3], [16, 4.5, 10], (600, 3))])
    cfg = tc.EngineConfig(
        orb=tc.OrbConfig(n_features=512, n_levels=4),
        camera=tc.CameraConfig(width=world.W, height=world.H, fx=world.fx,
                               fy=world.fy, cx=world.cx, cy=world.cy),
        map=tc.MapConfig(max_keyframes=48, max_landmarks=4096, ba_window=4),
        tracking=tc.TrackingConfig(
            pipeline_stretch=1, init_min_matches=40, kf_max_interval=5,
            atlas_reloc_patience=8, atlas_min_kf=5))

    def cam_at(x):
        return np.eye(3), -np.array([x, 0.0, 0.0])

    poses = ([cam_at(1.2 * k / 44) for k in range(45)] + [None] * 15
             + [cam_at(10.0 - 0.8 * k / 29) for k in range(30)]
             + [cam_at(9.2 - 8.2 * k / 109) for k in range(110)]
             + [cam_at(1.0)] * 10)
    s = tsys.System(cfg, device="cpu")
    states, froze = [], False
    for k, pose in enumerate(poses):
        img = (np.zeros((world.H, world.W), np.float32) if pose is None
               else world.render(*pose))
        states.append(s.track_monocular(img, k / 30.0).tracking_state)
        froze = froze or len(s.atlas) > 0
    assert froze, "tracking loss never froze map 1 into the atlas"
    assert s.welds_done >= 1, (len(s.atlas), states[-20:])
    assert len(s.atlas) == 0
    assert states[-10:].count(tsys.TRACKING_OK) >= 8, states[-10:]
