"""Sim(3) of the port against the JAX package on the CPU: exp, log,
compose and inverse at generic, small-angle and small-scale twists; the
pose graph's per-edge (7, 2, 7) forward-mode Jacobian at a zero and a
random correction against ``jax.jacfwd``; weighted and masked Umeyama;
and the Sim(3) RANSAC with the JAX package's own Gumbel draws injected.

Tolerances: exp/log/compose/inverse 1e-6 absolute on unit-size inputs
(a few float32 ulps; the forms are the same line by line); Jacobians
5e-6 absolute on entries of size ~1 (forward mode, float32); Umeyama and
RANSAC s/R/t 1e-5, inlier masks equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from send_slam_tpu.geometry import sim3 as jsim3
from send_slam_tpu.models import sim3_solver as jsolver
from send_slam_tpu_torch.geometry import sim3 as tsim3
from send_slam_tpu_torch.models import pose_graph as tpg
from send_slam_tpu_torch.models import sim3_solver as tsolver

torch.set_num_threads(1)

RNG = np.random.default_rng(17)


def _twist(kind):
    rng = np.random.default_rng({"generic": 1, "small_angle": 2,
                                 "small_scale": 3, "zero": 4}[kind])
    xi = rng.normal(size=7) * 0.4
    if kind == "small_angle":
        xi[3:6] *= 1e-7
    elif kind == "small_scale":
        xi[6] = 3e-6
    elif kind == "zero":
        xi[:] = 0.0
    return xi.astype(np.float32)


def _rot(v):
    return Rotation.from_rotvec(v).as_matrix().astype(np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol)


@pytest.mark.parametrize("kind", ["generic", "small_angle", "small_scale",
                                  "zero"])
def test_exp_log_compose_inverse(kind):
    xi = _twist(kind)
    sj, Rj, tj = jsim3.sim3_exp(jnp.asarray(xi))
    st, Rt, tt = tsim3.sim3_exp(torch.from_numpy(xi))
    for a, b in ((sj, st), (Rj, Rt), (tj, tt)):
        _close(a, b, 1e-6)
    _close(jsim3.sim3_log(sj, Rj, tj), tsim3.sim3_log(st, Rt, tt), 1e-6)
    _close(jsim3._sim3_W(jnp.asarray(xi[3:6]), jnp.asarray(xi[6])),
           tsim3._sim3_W(torch.from_numpy(xi[3:6]), torch.tensor(xi[6])),
           1e-6)

    xb = _twist("generic")[::-1].copy()
    sbj, Rbj, tbj = jsim3.sim3_exp(jnp.asarray(xb))
    sbt, Rbt, tbt = tsim3.sim3_exp(torch.from_numpy(xb))
    for a, b in zip(jsim3.sim3_compose(sj, Rj, tj, sbj, Rbj, tbj),
                    tsim3.sim3_compose(st, Rt, tt, sbt, Rbt, tbt)):
        _close(a, b, 1e-6)
    for a, b in zip(jsim3.sim3_inverse(sj, Rj, tj),
                    tsim3.sim3_inverse(st, Rt, tt)):
        _close(a, b, 1e-6)
    x = RNG.normal(size=(5, 3)).astype(np.float32)
    _close(jsim3.sim3_apply(sj, Rj, tj, jnp.asarray(x)),
           tsim3.sim3_apply(st, Rt, tt, torch.from_numpy(x)), 1e-5)


def _edge(consistent):
    """Poses of nodes i, j and the inverse of the measurement S_ji: the
    current relative pose when ``consistent`` (a zero residual, the
    residual rotation at the identity), else a perturbed one."""
    Ri, Rj = _rot([0.2, -0.1, 0.3]), _rot([-0.3, 0.2, 0.1])
    ti = np.array([0.5, -0.2, 1.0], np.float32)
    tj = np.array([-0.4, 0.3, 0.7], np.float32)
    sii, Rii, tii = jsim3.sim3_inverse(jnp.ones(()), jnp.asarray(Ri),
                                       jnp.asarray(ti))
    sm, Rm, tm = jsim3.sim3_compose(jnp.ones(()), jnp.asarray(Rj),
                                    jnp.asarray(tj), sii, Rii, tii)
    if not consistent:
        sm, Rm, tm = jsim3.sim3_compose(jnp.asarray(1.1),
                                        jnp.asarray(_rot([0.05, 0, -0.04])),
                                        jnp.asarray([0.1, 0.0, -0.1]),
                                        sm, Rm, tm)
    smi, Rmi, tmi = jsim3.sim3_inverse(sm, Rm, tm)
    return [np.array(a, np.float32) for a in
            (Ri, ti, Rj, tj, smi, Rmi, tmi)]


def _jax_edge_jacobian(xi2, edge):
    Ri, ti, Rj, tj, sm, Rm, tm = (jnp.asarray(a) for a in edge)

    def f(x):
        dsi, dRi, dti = jsim3.sim3_exp(x[0])
        si_, Ri_, ti_ = jsim3.sim3_compose(dsi, dRi, dti, jnp.ones(()), Ri,
                                           ti)
        dsj, dRj, dtj = jsim3.sim3_exp(x[1])
        sj_, Rj_, tj_ = jsim3.sim3_compose(dsj, dRj, dtj, jnp.ones(()), Rj,
                                           tj)
        sii, Rii, tii = jsim3.sim3_inverse(si_, Ri_, ti_)
        s_ji, R_ji, t_ji = jsim3.sim3_compose(sj_, Rj_, tj_, sii, Rii, tii)
        return jsim3.sim3_log(*jsim3.sim3_compose(sm, Rm, tm, s_ji, R_ji,
                                                  t_ji))

    x = jnp.asarray(xi2)
    return np.asarray(f(x)), np.asarray(jax.jacfwd(f)(x))


@pytest.mark.parametrize("at", ["zero", "random"])
@pytest.mark.parametrize("consistent", [True, False])
def test_edge_jacobian_matches_jacfwd(at, consistent):
    """At a zero correction (GN iteration 0) both the small-angle and the
    small-scale branch of W hold; a consistent edge also puts the
    residual's rotation at the identity, where so3_log's cosine clip
    saturates. The port's Jacobian is the derivative of the branch the
    reference selects."""
    xi2 = (np.zeros((2, 7)) if at == "zero"
           else np.random.default_rng(5).normal(size=(2, 7)) * 0.1
           ).astype(np.float32)
    edge = _edge(consistent)
    r_j, J_j = _jax_edge_jacobian(xi2, edge)
    J_t, r_t = tpg._edge_jacobians(
        torch.from_numpy(xi2)[None], *(torch.from_numpy(a)[None]
                                       for a in edge))
    assert J_t.shape == (1, 7, 2, 7)
    np.testing.assert_allclose(r_t[0].numpy(), r_j, atol=1e-6)
    np.testing.assert_allclose(J_t[0].numpy(), J_j, atol=5e-6)
    assert np.abs(J_j).max() > 0.5


def test_edge_jacobians_batch_equals_single():
    """The batched evaluation gives every edge its own Jacobian."""
    edges = [_edge(c) for c in (True, False)]
    xi2 = np.random.default_rng(6).normal(size=(2, 2, 7)).astype(
        np.float32) * 0.1
    batch = [torch.from_numpy(np.stack([e[k] for e in edges]))
             for k in range(7)]
    J, r = tpg._edge_jacobians(torch.from_numpy(xi2), *batch)
    for e in range(2):
        J1, r1 = tpg._edge_jacobians(torch.from_numpy(xi2[e:e + 1]),
                                     *(b[e:e + 1] for b in batch))
        np.testing.assert_allclose(J[e].numpy(), J1[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(r[e].numpy(), r1[0].numpy(), atol=1e-6)


def _clouds(n=120, outliers=30, seed=9):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    R = _rot([0.2, -0.3, 0.1])
    dst = (1.35 * src @ R.T + np.array([0.5, -1.0, 2.0])).astype(np.float32)
    dst += rng.normal(0, 0.005, dst.shape).astype(np.float32)
    dst[:outliers] += rng.uniform(1, 3, (outliers, 3)).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("weights", ["none", "weighted", "masked"])
def test_umeyama(weights):
    src, dst = _clouds(outliers=0)
    w = None
    if weights == "weighted":
        w = np.random.default_rng(3).uniform(0.2, 2.0, len(src)).astype(
            np.float32)
    elif weights == "masked":
        src = src.copy()
        src[100:] = 999.0
        w = np.ones(len(src), np.float32)
        w[100:] = 0.0
    sj, Rj, tj = jsolver.umeyama_sim3(
        jnp.asarray(src), jnp.asarray(dst),
        None if w is None else jnp.asarray(w))
    st, Rt, tt = tsolver.umeyama_sim3(
        torch.from_numpy(src), torch.from_numpy(dst),
        None if w is None else torch.from_numpy(w))
    for a, b in ((sj, st), (Rj, Rt), (tj, tt)):
        _close(a, b, 1e-5)
    assert abs(float(st) - 1.35) < 1e-2


def test_umeyama_batched_equals_single():
    src, dst = _clouds(outliers=0)
    idx = np.random.default_rng(4).integers(0, len(src), (6, 3))
    sb, Rb, tb = tsolver.umeyama_sim3(torch.from_numpy(src[idx]),
                                      torch.from_numpy(dst[idx]))
    for h in range(6):
        s1, R1, t1 = tsolver.umeyama_sim3(torch.from_numpy(src[idx[h]]),
                                          torch.from_numpy(dst[idx[h]]))
        np.testing.assert_allclose(sb[h].numpy(), s1.numpy(), rtol=1e-5)
        np.testing.assert_allclose(Rb[h].numpy(), R1.numpy(), atol=1e-5)
        np.testing.assert_allclose(tb[h].numpy(), t1.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", ["outliers", "masked", "starved"])
def test_sim3_ransac_with_jax_draws(case):
    """The JAX package's Gumbel draws for a key, injected into the port:
    the same inliers and the same similarity. ``starved`` leaves two
    valid pairs, so the -inf draws tie and fall to the lower index."""
    src, dst = _clouds()
    valid = np.ones(len(src), bool)
    if case == "masked":
        valid[::3] = False
    elif case == "starved":
        valid[:] = False
        valid[[40, 77]] = True
    key = jax.random.PRNGKey(3)
    rj = jsolver.sim3_ransac(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(valid), key)
    noise = np.asarray(jax.random.gumbel(key, (128, len(src))))
    rt = tsolver.sim3_ransac(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(valid),
                             torch.from_numpy(noise))
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    assert bool(rt.ok) == bool(rj.ok)
    if case != "starved":
        assert bool(rt.ok) and int(rt.n_inliers) >= 60
        for f in ("s", "R", "t"):
            _close(getattr(rj, f), getattr(rt, f), 1e-5)
    else:
        assert not bool(rt.ok)


def test_gumbel_noise_from_generator():
    """One draw per call from the CPU generator, reproducible after a
    reseed, finite."""
    g = torch.Generator().manual_seed(0)
    a = tsolver.gumbel_noise(g, (3, 128, 50), "cpu")
    b = tsolver.gumbel_noise(g, (3, 128, 50), "cpu")
    g.manual_seed(0)
    np.testing.assert_array_equal(
        tsolver.gumbel_noise(g, (3, 128, 50), "cpu").numpy(), a.numpy())
    assert not torch.equal(a, b) and torch.isfinite(a).all()
