"""Loop closing of the port against the JAX package on the CPU, from the
carried map of test_torch_pose_graph.py (one out-and-back pass, so the
newest keyframes revisit the first): retrieval candidates, the Sim(3)
verification with the JAX package's Gumbel draws injected, the
reprojection median, the loop correction, the global BA over every
keyframe slot in one block against the JAX package's chunked and
single-block assembly, the System's loop state machine under scripted
scores, and a whole loop session on the port alone (marked slow: about
two minutes on one worker).

Tolerances, stated per check: candidate ids exact, scores 1e-6; the
verification's verdict, candidate and match count exact, inliers +-2,
s/R/t 1e-4 (JAX runs the same draws through XLA's own reductions);
medians 1e-5 relative; the correction's poses and landmarks 1e-3 (15
Gauss-Newton iterations through a 7*MK dense solve); global BA as
tests/test_local_ba.py holds the chunked path against the single block
(kf_t 2e-3, lm_pos 5e-3 after 8 iterations) and 1e-3 against the
single block, as the BA tests use, for poses and for landmarks seen by
at least 3 keyframes. A landmark seen twice is held to the chunked bar
against both: on the carried map the JAX package's own two assemblies
differ by 2.6e-3 on such landmarks (one moved 1.1 m in 8 iterations),
and the port's single block lies between them."""

import dataclasses
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.models import local_ba as jba
from send_slam_tpu.models import loop_closing as jlc
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu_torch.models import local_ba as tba
from send_slam_tpu_torch.models import loop_closing as tlc
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.map_state import map_to_numpy
from test_torch_pose_graph import jmap, revisit, tmap  # noqa: F401

torch.set_num_threads(1)

GEOM = ("kf_R", "kf_t", "lm_pos", "lm_dist_min", "lm_dist_max")


def newest(m_np):
    return int(m_np["n_kf"]) - 1


def jax_noise(key, n_cands, N):
    """The Gumbel draws compute_loop_sim3_multi takes from ``key``: one
    split per candidate, one (128, N) block each."""
    keys = jax.random.split(key, n_cands)
    return np.stack([np.asarray(jax.random.gumbel(k, (tlc.N_HYP, N)))
                     for k in keys])


@pytest.mark.parametrize("min_gap", [4, 20])
def test_loop_candidates(revisit, min_gap):
    m = revisit[1]
    for kf in range(newest(m) - 3, newest(m) + 1):
        cj, sj = jlc.loop_candidates(jmap(m), jnp.asarray(kf, jnp.int32),
                                     min_gap, k=3)
        ct, st = tlc.loop_candidates(tmap(m), kf, min_gap, k=3)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
        assert ct.dtype == torch.int32
        if min_gap == 20:           # nothing that far: all -1, ties to 0
            np.testing.assert_array_equal(ct.numpy(), [0, 1, 2])


def _verify_both(m, kf, cands, key, cfg_j, cfg_t):
    N = m["kf_uv"].shape[1]
    lj, cand_j = jlc.compute_loop_sim3_multi(
        jmap(m), jnp.asarray(kf, jnp.int32), jnp.asarray(cands, jnp.int32),
        key, cfg_j.tracking, min_matches=cfg_j.tracking.loop_min_matches)
    lt, cand_t = tlc.compute_loop_sim3_multi(
        tmap(m), kf, torch.tensor(cands, dtype=torch.int32),
        torch.from_numpy(jax_noise(key, len(cands), N)), cfg_t.tracking,
        min_matches=cfg_t.tracking.loop_min_matches)
    return lj, cand_j, lt, cand_t


def assert_loop_close(lj, cand_j, lt, cand_t, atol=1e-4):
    assert bool(lt.ok) == bool(lj.ok)
    assert int(cand_t) == int(cand_j)
    assert int(lt.n_matches) == int(lj.n_matches)
    assert abs(int(lt.sim3.n_inliers) - int(lj.sim3.n_inliers)) <= 2
    for f in ("s", "R", "t"):
        np.testing.assert_allclose(getattr(lt.sim3, f).numpy(),
                                   np.asarray(getattr(lj.sim3, f)),
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_loop_sim3_multi(revisit, seed):
    """The newest keyframe against its retrieval candidates: a real
    revisit verifies; the winner is the verified candidate with the
    most inliers."""
    from test_torch_system import engine_cfg
    s, m = revisit
    kf = newest(m)
    cands, _ = jlc.loop_candidates(jmap(m), jnp.asarray(kf, jnp.int32), 4)
    lj, cand_j, lt, cand_t = _verify_both(
        m, kf, np.asarray(cands), jax.random.PRNGKey(seed), engine_cfg(jc),
        engine_cfg(tc))
    assert_loop_close(lj, cand_j, lt, cand_t)
    assert bool(lt.ok) and int(lt.sim3.n_inliers) >= 20


def test_compute_loop_sim3_rejects_a_non_revisit(revisit):
    """Keyframes that share no landmarks: too few matches, no loop."""
    from test_torch_system import engine_cfg
    m = revisit[1]
    cands = np.array([newest(m), 0, 1], np.int32)
    kf = int(np.flatnonzero(m["kf_valid"])[len(np.flatnonzero(
        m["kf_valid"])) // 2])
    lj, cand_j, lt, cand_t = _verify_both(
        m, kf, cands, jax.random.PRNGKey(7), engine_cfg(jc), engine_cfg(tc))
    assert int(lt.n_matches) == int(lj.n_matches)
    assert bool(lt.ok) == bool(lj.ok)
    assert int(cand_t) == int(cand_j)


@pytest.mark.parametrize("values", [[1.0, 2.0, 3.0, 4.0, np.nan],
                                    [5.0, np.nan, 1.0, 2.0],
                                    [3.0, 1.0, 2.0],
                                    [np.nan, np.nan], [7.5]])
def test_nanmedian_is_numpys(values):
    """jnp.nanmedian averages the two middle values of an even count;
    torch.nanmedian returns the lower one (2.0 against 2.5 on the first
    case)."""
    x = np.asarray(values, np.float32)
    got = float(tlc.nanmedian(torch.from_numpy(x)))
    want = float(jnp.nanmedian(jnp.asarray(x)))
    np.testing.assert_equal(got, want)
    if values[0] == 1.0:
        assert got == 2.5 and float(torch.nanmedian(torch.from_numpy(x))) \
            == 2.0


@pytest.mark.parametrize("drop", [0, 1])
def test_map_reprojection_median(revisit, drop):
    """The carried map, and with one more observation dropped so the
    count's parity flips."""
    m = {k: v.copy() for k, v in revisit[1].items()}
    if drop:
        k, n = np.argwhere(m["kf_obs_lm"] >= 0)[0]
        m["kf_obs_lm"][k, n] = -1
    cam = engine_cam()
    j = float(jlc.map_reprojection_median(jmap(m), *cam))
    t = float(tlc.map_reprojection_median(tmap(m), *cam))
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert 0.0 < t < 5.0


def well_seen(m_np, k=3):
    """(ML,) landmarks observed by at least ``k`` valid keyframes."""
    obs = m_np["kf_obs_lm"][m_np["kf_valid"]]
    n = np.bincount(obs[obs >= 0], minlength=m_np["lm_pos"].shape[0])
    return n >= k


def assert_ba_close(b, a, m_np, atol=1e-3):
    """Poses to ``atol``; landmarks seen 3+ times to ``atol``, all to
    5e-3 (see the module docstring)."""
    for f in ("kf_R", "kf_t"):
        np.testing.assert_allclose(b[f], a[f], atol=atol, err_msg=f)
    ok = well_seen(m_np)
    np.testing.assert_allclose(b["lm_pos"][ok], a["lm_pos"][ok], atol=atol)
    np.testing.assert_allclose(b["lm_pos"], a["lm_pos"], atol=5e-3)


def engine_cam():
    from test_torch_system import engine_cfg
    c = engine_cfg(tc).camera
    return c.fx, c.fy, c.cx, c.cy


@pytest.mark.parametrize("bend", [False, True])
def test_apply_loop_correction(revisit, bend):
    """The verified loop of the newest keyframe, applied on both sides
    from the same LoopSim3 (the JAX one, carried over). The carried map
    barely drifts, so ``bend`` also scales the measured Sim(3) by 8%,
    turns it by 3 degrees and keeps covisibility edges within 3 slots
    (``covis_max_gap``), so the revisit's direct edges do not hold the
    loop back: a correction well above the tolerance."""
    from test_torch_system import engine_cfg
    m = revisit[1]
    kf = newest(m)
    cands, _ = jlc.loop_candidates(jmap(m), jnp.asarray(kf, jnp.int32), 4)
    lj, cand_j = jlc.compute_loop_sim3_multi(
        jmap(m), jnp.asarray(kf, jnp.int32), cands, jax.random.PRNGKey(0),
        engine_cfg(jc).tracking)
    assert bool(lj.ok)
    if bend:
        a = np.deg2rad(3.0)
        c, sn = np.cos(a), np.sin(a)
        Rz = jnp.asarray([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], jnp.float32)
        lj = lj._replace(sim3=lj.sim3._replace(
            s=lj.sim3.s * 1.08, R=Rz @ lj.sim3.R, t=lj.sim3.t * 1.08))
    gap = 3 if bend else 0
    mj = jlc.apply_loop_correction(jmap(m), jnp.asarray(kf, jnp.int32),
                                   cand_j, lj, covis_max_gap=gap)
    lt = tlc.LoopSim3(
        ok=torch.tensor(bool(lj.ok)),
        n_matches=torch.tensor(int(lj.n_matches)),
        sim3=tlc.Sim3Result(*(torch.from_numpy(np.array(x))
                              for x in lj.sim3)))
    mt = tlc.apply_loop_correction(tmap(m), kf, int(cand_j), lt,
                                   covis_max_gap=gap)
    a = {f: np.asarray(v) for f, v in mj._asdict().items()}
    b = map_to_numpy(mt)
    for f in GEOM:
        np.testing.assert_allclose(b[f], a[f], atol=1e-3, err_msg=f)
    moved = max(np.abs(a["kf_t"] - m["kf_t"]).max(),
                np.abs(a["lm_pos"] - m["lm_pos"]).max())
    assert moved > (1e-1 if bend else 1e-5)


@pytest.mark.parametrize("case", ["revisit", "synthetic"])
def test_global_bundle_adjustment_unchunked(revisit, case):
    """The port's one-block global BA against the JAX package's chunked
    assembly (a forced small kf_chunk, as tests/test_local_ba.py) and
    its single block."""
    from test_local_ba import K as K_syn, make_problem
    if case == "revisit":
        from test_torch_system import engine_cfg
        m_np = revisit[1]
        cfg = engine_cfg(jc).map
        c = engine_cfg(tc).camera
        K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]],
                     np.float32)
    else:
        mj0, cfg, *_ = make_problem(pose_noise=0.05, lm_noise=0.08)
        m_np = {f: np.array(v) for f, v in mj0._asdict().items()}
        K = np.asarray(K_syn)
    whole = dataclasses.replace(cfg, ba_window=cfg.max_keyframes)
    W = whole.ba_window
    mj = jmap(m_np)
    chunked = jba.local_bundle_adjustment(mj, jnp.asarray(K), whole,
                                          iters=8, kf_chunk=W // 4)
    single = jba.global_bundle_adjustment(mj, jnp.asarray(K), cfg, iters=8)
    assert W <= 64        # the JAX package's single block (kf_chunk = 64)
    tcfg = tc.MapConfig(max_keyframes=cfg.max_keyframes,
                        max_landmarks=cfg.max_landmarks,
                        ba_window=cfg.ba_window)
    mt = tba.global_bundle_adjustment(tmap(m_np), torch.from_numpy(K), tcfg,
                                      iters=8)
    b = map_to_numpy(mt)
    np.testing.assert_allclose(b["kf_t"], np.asarray(chunked.kf_t), atol=2e-3)
    np.testing.assert_allclose(b["lm_pos"], np.asarray(chunked.lm_pos),
                               atol=5e-3)
    assert_ba_close(b, {f: np.asarray(v) for f, v in single._asdict().items()},
                    m_np)
    assert np.abs(b["lm_pos"] - m_np["lm_pos"]).max() > 1e-4


@pytest.mark.parametrize("lam,prune,atol", [(1e-3, False, 1e-3),
                                            (1e-4, True, 1e-3),
                                            (1e-5, True, 5e-3)])
def test_global_slice(revisit, lam, prune, atol):
    """The System's global polish slice (every keyframe slot, one
    iteration) against the JAX System's, at the first, a middle and the
    last damping of the queued schedule. At the floor damping 1e-5 the
    one-iteration step is ill-conditioned in float32: on this map the
    JAX package's jitted and eager slices differ by 3.6e-3 in landmarks,
    so that case holds 5e-3."""
    from test_torch_system import engine_cfg
    s, m = revisit
    port = tsys.System(engine_cfg(tc), device="cpu")
    mj, dRj, dtj, bigj = s._global_slice(
        jmap(m), jnp.asarray(lam, jnp.float32), jnp.asarray(prune))
    mt, dRt, dtt, bigt = port._global_slice(tmap(m), lam, prune)
    a = {f: np.asarray(v) for f, v in mj._asdict().items()}
    b = map_to_numpy(mt)
    assert_ba_close(b, a, m, atol=atol)
    assert (a["kf_obs_lm"] != b["kf_obs_lm"]).sum() <= 2
    np.testing.assert_allclose(dRt.numpy(), np.asarray(dRj), atol=1e-3)
    assert bool(bigt) == bool(bigj)


# --- the System's loop state machine under scripted scores ---------------

def _done(x):
    f = Future()
    f.set_result(np.asarray(x))
    return f


class Pair:
    """A JAX System and a port System on the same carried map and loop
    state, driven through the same script: each probe's top candidates
    and score are injected where the keyframe insert would retrieve
    them; the Sim(3) verdict can be forced; the sanity gate can be
    forced to reject."""

    def __init__(self, revisit, verdict=True, reject=False):
        from test_torch_system import engine_cfg
        s0, m = revisit
        self.m = m
        self.js = JSystem(engine_cfg(jc))
        self.ts = tsys.System(engine_cfg(tc), device="cpu")
        self.js.map, self.js._st = s0.map, s0._st
        self.js.state = self.ts.state = tsys.TRACKING_OK
        self.js._n_kf_host = self.ts._n_kf_host = 40
        self.ts.map = tmap(m)
        self.ts._st = tsys.loop_state_from_numpy(
            {f: np.array(v) for f, v in s0._st._asdict().items()}, "cpu")
        self.st0 = tsys.loop_state_to_numpy(self.ts._st)
        key = jax.random.PRNGKey(11)
        N = m["kf_uv"].shape[1]
        cfg_j, cfg_t = engine_cfg(jc).tracking, engine_cfg(tc).tracking

        # Both sides verify the first candidate from the same draws.
        def j_sim3(mm, kf, cands, _key):
            res = jlc.compute_loop_sim3(mm, kf, cands[0], key, cfg_j,
                                        cfg_j.loop_min_matches)
            return res._replace(ok=jnp.asarray(verdict)), cands[0]

        noise = torch.from_numpy(np.asarray(
            jax.random.gumbel(key, (tlc.N_HYP, N))))

        def t_sim3(mm, kf, cands, _noise):
            res = tlc.compute_loop_sim3(mm, kf, cands[0], noise, cfg_t,
                                        cfg_t.loop_min_matches)
            return res._replace(ok=torch.tensor(verdict)), cands[0]

        self.js._loop_sim3, self.ts._loop_sim3 = j_sim3, t_sim3
        if reject:
            ja, ta = self.js._loop_apply, self.ts._loop_apply

            def j_apply(*a):
                m2, dR, dt, mb, _ = ja(*a)
                return m2, dR, dt, mb, jnp.asarray(1e6, jnp.float32)

            def t_apply(*a):
                m2, dR, dt, mb, _ = ta(*a)
                return m2, dR, dt, mb, torch.tensor(1e6)

            self.js._loop_apply, self.ts._loop_apply = j_apply, t_apply

    def probe(self, kf_slot, cands, score):
        cands = np.asarray(cands, np.int32)
        score = np.float32(score)
        assert self.js._pending_loop is None and self.ts._pending_loop is None
        self.js._pending_loop = (kf_slot, jnp.asarray(cands),
                                 _done(score), _done(cands[0]))
        self.ts._pending_loop = dict(
            kf_slot=kf_slot, cands=torch.from_numpy(cands),
            scores=torch.tensor([score, score - 0.1, score - 0.2]))

    def step(self):
        """One drained frame's loop phase on both; the records, the
        consistency counter, the applied-closure count and the queued
        polish must agree."""
        self.js._maybe_close_loop()
        self.ts._maybe_close_loop()
        assert self.ts.loop_attempts == self.js.loop_attempts
        assert self.ts._loop_consistency == self.js._loop_consistency
        assert self.ts.loops_closed == self.js.loops_closed
        assert self.ts._last_loop_nkf == self.js._last_loop_nkf
        assert self.ts._polish_queue == self.js._polish_queue
        assert (self.ts._pending_loop is None) == \
            (self.js._pending_loop is None)
        return self.ts.loop_attempts[-1] if self.ts.loop_attempts else None


@pytest.mark.parametrize("score", [0.2, 0.35, 0.995, 0.999])
def test_state_machine_score_band(revisit, score):
    """A score at or below loop_score_min or at or above loop_score_max
    ends the probe and clears the consistency run."""
    p = Pair(revisit)
    kf = newest(p.m)
    p.probe(kf, [1, 0, 2], score)
    rec = p.step()
    assert rec == (kf, 1, float(np.float32(score)), None)
    assert p.ts._loop_consistency is None and p.ts._pending_loop is None


def test_state_machine_consistency_then_unverified(revisit):
    """Two probes must point at one region (within
    loop_consistency_radius slots) before a verification is spent; a
    probe elsewhere restarts the run; an unverified loop is recorded
    with False."""
    p = Pair(revisit, verdict=False)
    kf = newest(p.m)
    p.probe(kf, [1, 0, 2], 0.6)
    assert p.step() == (kf, 1, float(np.float32(0.6)), None)
    assert p.ts._loop_consistency == (1, 1)
    p.probe(kf, [9, 0, 2], 0.6)            # another region: run restarts
    assert p.step()[3] is None and p.ts._loop_consistency == (9, 1)
    p.probe(kf, [1, 0, 2], 0.7)            # back: run 1 again
    assert p.step()[3] is None
    p.probe(kf, [2, 0, 1], 0.7)            # within the radius: run 2
    assert p.step()[3] is None and len(p.ts.loop_attempts) == 3
    assert p.ts._pending_loop is not None   # verification dispatched
    assert p.step() == (kf, 2, float(np.float32(0.7)), False, None)
    assert p.ts.loops_closed == 0 and not p.ts._polish_queue


def test_state_machine_verified_applies_and_polishes(revisit):
    """A verified loop is applied on the next drained frame (map and
    chain corrected at once), and judged sane on the one after: the
    global polish is queued and the cooldown armed."""
    p = Pair(revisit)
    kf = newest(p.m)
    for cands in ([1, 0, 2], [1, 2, 0]):
        p.probe(kf, cands, 0.8)
        p.step()
    assert p.ts._pending_loop is not None
    m_pre = p.ts.map
    p.step()                                # phase 2: applied, unjudged
    assert p.ts._pending_loop_sanity is not None
    assert p.ts.map is not m_pre
    a = {f: np.asarray(v) for f, v in p.js.map._asdict().items()}
    b = map_to_numpy(p.ts.map)
    for f in GEOM:
        np.testing.assert_allclose(b[f], a[f], atol=1e-3, err_msg=f)
    st_j = {f: np.asarray(v) for f, v in p.js._st._asdict().items()}
    st_t = tsys.loop_state_to_numpy(p.ts._st)
    for f in ("R", "t", "R2", "t2"):
        np.testing.assert_allclose(st_t[f], st_j[f], atol=1e-3, err_msg=f)
    rec = p.step()                          # phase 3: the verdict
    assert rec == (kf, 1, float(np.float32(0.8)), True, 1)
    assert p.ts.loops_closed == 1 and p.ts.session_loops_applied == 1
    assert [q[0] for q in p.ts._polish_queue] == ["global"] * 8
    assert p.ts._last_loop_nkf == 40


def test_state_machine_sanity_rejection_rolls_back(revisit):
    """A closure whose median reprojection error explodes is rolled
    back: the pre-apply map is restored, the chain inverse-rebased, the
    probe and the consistency run dropped; nothing else is restored."""
    p = Pair(revisit, reject=True)
    kf = newest(p.m)
    for cands in ([1, 0, 2], [1, 2, 0]):
        p.probe(kf, cands, 0.8)
        p.step()
    m_pre = p.ts.map
    p.step()
    assert p.ts.map is not m_pre
    moved = np.abs(tsys.loop_state_to_numpy(p.ts._st)["t"]
                   - p.st0["t"]).max()
    rec = p.step()
    assert rec == (kf, 1, float(np.float32(0.8)), "rejected", None)
    assert p.ts.map is m_pre
    st = tsys.loop_state_to_numpy(p.ts._st)
    for f in ("R", "t", "R2", "t2"):
        np.testing.assert_allclose(st[f], p.st0[f], atol=1e-5, err_msg=f)
    assert moved > 1e-4
    assert p.ts._pending_loop is None and p.ts._loop_consistency is None
    assert p.ts.loops_closed == 0 and not p.ts._polish_queue


def test_flush_judges_a_pending_closure(revisit):
    """A closure applied on the last drained frame is judged when the
    pipeline drains (state transitions and shutdown)."""
    p = Pair(revisit)
    kf = newest(p.m)
    for cands in ([1, 0, 2], [1, 2, 0]):
        p.probe(kf, cands, 0.8)
        p.step()
    p.step()
    assert p.ts._pending_loop_sanity is not None
    p.ts._flush_pipeline()
    p.js._flush_pipeline()
    assert p.ts._pending_loop_sanity is None
    assert p.ts.loop_attempts == p.js.loop_attempts
    assert p.ts.loop_attempts[-1][3] is True


@pytest.mark.slow
def test_loop_session_on_the_port():
    """tests/test_loop_e2e.py's out-and-back revisit at its small
    configuration on the port's CPU path: a loop closes, the corrected
    keyframe trajectory is under that test's bar, and no timestamp is
    emitted twice (live poses, their backfill and the shutdown drain;
    a warm-up repeat of the last output is not a new emission) but the
    init commit frame's, which the JAX package emits twice as well: the
    init backfill takes the cached frames strictly between the committed
    pair by comparing their float64 timestamps with the commit frame's
    float32 device timestamp, which can round up past its own."""
    from send_slam_tpu_torch.io.evaluate import ate_rmse
    from send_slam_tpu_torch.utils.synth import SyntheticWorld
    from test_loop_e2e import out_and_back
    world = SyntheticWorld(n_points=700, seed=5)
    cfg = tc.EngineConfig(
        orb=tc.OrbConfig(n_features=512, n_levels=4),
        camera=tc.CameraConfig(width=world.W, height=world.H, fx=world.fx,
                               fy=world.fy, cx=world.cx, cy=world.cy),
        map=tc.MapConfig(max_keyframes=64, max_landmarks=4096, ba_window=4),
        tracking=tc.TrackingConfig(init_min_matches=50, pipeline_depth=2,
                                   pipeline_stretch=1, loop_min_gap_kf=10))
    ts, Rs, tls = out_and_back()
    s = tsys.System(cfg, device="cpu")
    emitted, n_ok, last_ts = [], 0, None
    for k in range(len(ts)):
        out = s.track_monocular(world.render(Rs[k], tls[k]), float(ts[k]))
        if out.tracking_state == tsys.TRACKING_OK \
                and out.timestamp != last_ts:
            n_ok += 1
            emitted.append(out.timestamp)
        last_ts = out.timestamp
        emitted.extend(b[0] for b in out.backfill)
    for out in s.shutdown():
        if out.tracking_state == tsys.TRACKING_OK:
            emitted.append(out.timestamp)
        emitted.extend(b[0] for b in out.backfill)
    assert n_ok > 80, n_ok
    assert s.loops_closed >= 1, s.loop_attempts
    twice = sorted({t for t in emitted if emitted.count(t) > 1})
    assert twice in ([], [s.init_commit_ts]), twice
    assert all(emitted.count(t) <= 2 for t in twice)
    gt = np.asarray([-R.T @ t for R, t in zip(Rs, tls)])
    kts, kpos, _ = s.keyframe_poses()
    err = ate_rmse(kts, kpos, ts, gt)
    assert err < 0.06, err
