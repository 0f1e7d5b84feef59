"""The essential graph and the Sim(3) pose graph of the port against
the JAX package on the CPU.

``revisit`` is a JAX System's carried map after one out-and-back pass of
the multi-lap scene at the small configuration of test_torch_system.py
(loop closing off; culled keyframes leave holes in the table), so the
newest keyframes revisit the first ones.

Edge sets are integer selections (a top-k over integer covisibility
masses, a running max over slots), so ids and validity must be equal,
ties included; the relative poses measured from them to 1e-6. The pose
graph to 1e-4: the reference runs it jitted and sums the Hessian blocks
in scatter order, the port in ascending order per block, and 15-25
Gauss-Newton iterations carry that through a dense solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
from send_slam_tpu.models import covisibility as jcov
from send_slam_tpu.models import pose_graph as jpg
from send_slam_tpu.models.map_state import MapState as JMap
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.models import covisibility as tcov
from send_slam_tpu_torch.models import pose_graph as tpg
from send_slam_tpu_torch.models.map_state import map_from_numpy

torch.set_num_threads(1)

REVISIT_FRAMES = 100


@pytest.fixture(scope="module")
def revisit():
    """(JAX System, its map as numpy) after one out-and-back pass."""
    from test_torch_system import engine_cfg
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory_laps(n_frames=REVISIT_FRAMES, laps=1.0)
    s = JSystem(engine_cfg(jc))
    for k in range(REVISIT_FRAMES):
        s.track_monocular(np.round(w.render(Rs[k], tls[k])).astype(np.uint8),
                          float(ts[k]))
    m_np = {f: np.array(v) for f, v in s.map._asdict().items()}
    n = int(m_np["n_kf"])
    assert n >= 10 and not m_np["kf_valid"][:n].all()
    return s, m_np


def jmap(m_np):
    return JMap(**{k: jnp.asarray(v) for k, v in m_np.items()})


def tmap(m_np):
    return map_from_numpy(m_np, device="cpu")


def variant(m_np, kind):
    """The carried map, or with a relocalization break on a keyframe and
    one more culling hole."""
    m = {k: v.copy() for k, v in m_np.items()}
    if kind == "break":
        valid = np.flatnonzero(m["kf_valid"][:int(m["n_kf"])])
        m["kf_chain_break"][valid[3]] = True
        m["kf_valid"][valid[5]] = False
    return m


def assert_edges_equal(ej, et):
    for f in ("i", "j", "valid"):
        np.testing.assert_array_equal(getattr(et, f).numpy(),
                                      np.asarray(getattr(ej, f)), err_msg=f)
    for f in ("s", "R", "t", "weight"):
        np.testing.assert_allclose(getattr(et, f).numpy(),
                                   np.asarray(getattr(ej, f)), atol=1e-6,
                                   err_msg=f)
    assert et.i.dtype == torch.int32 and et.j.dtype == torch.int32


@pytest.mark.parametrize("kind", ["carried", "break"])
def test_chain_edges(revisit, kind):
    m = variant(revisit[1], kind)
    ej, et = jcov.chain_edges(jmap(m)), tcov.chain_edges(tmap(m))
    assert_edges_equal(ej, et)
    v = et.valid.numpy()
    assert v.sum() >= 5
    if kind == "break":
        # The edge into the break is dropped, its neighbours are not.
        assert not v[m["kf_chain_break"]].any()


@pytest.mark.parametrize("kind", ["carried", "break"])
@pytest.mark.parametrize("top_k,min_shared,max_gap",
                         [(5, 30.0, 0), (3, 1.0, 0), (8, 0.0, 4)])
def test_covis_edges(revisit, kind, top_k, min_shared, max_gap):
    """Top-k partners by integer covisibility mass: ties everywhere
    (zero masses, and equal counts between keyframes that see the same
    landmarks), which must fall to the lower slot."""
    m = variant(revisit[1], kind)
    ej = jcov.covis_edges(jmap(m), top_k=top_k, min_shared=min_shared,
                          max_gap=max_gap)
    et = tcov.covis_edges(tmap(m), top_k=top_k, min_shared=min_shared,
                          max_gap=max_gap)
    assert_edges_equal(ej, et)
    assert et.valid.numpy().sum() >= 3
    C = tcov.covisibility_matrix(tmap(m)).numpy()
    assert any(len(np.unique(r[r > 0])) < (r > 0).sum() for r in C)


def test_build_sequential_and_concat(revisit):
    m = revisit[1]
    n = jnp.asarray(m["n_kf"])
    ej = jpg.build_sequential_edges(jnp.asarray(m["kf_R"]),
                                    jnp.asarray(m["kf_t"]),
                                    jnp.asarray(m["kf_valid"]), n)
    et = tpg.build_sequential_edges(torch.from_numpy(m["kf_R"]),
                                    torch.from_numpy(m["kf_t"]),
                                    torch.from_numpy(m["kf_valid"]),
                                    torch.from_numpy(np.array(m["n_kf"])))
    assert_edges_equal(ej, et)
    assert_edges_equal(jpg.concat_edges(ej, ej), tpg.concat_edges(et, et))


def _drifted_chain(MK=8):
    """tests/test_loop_closing.py's chain: poses along +x with drift
    0.15 per keyframe, and a loop edge 7 -> 0 measuring the true
    relative pose."""
    Rs = np.stack([np.eye(3, dtype=np.float32)] * MK)
    ts = np.stack([np.array([-float(i), 0, 0], np.float32)
                   for i in range(MK)])
    ts_drift = ts.copy()
    ts_drift[:, 0] -= 0.15 * np.arange(MK)
    return Rs, ts, ts_drift


def _to_torch_edges(e):
    return tpg.PoseGraphEdges(*[torch.from_numpy(np.array(x)) for x in e])


def test_optimize_pose_graph_drifted_chain():
    MK = 8
    Rs, ts, ts_drift = _drifted_chain(MK)
    valid = jnp.ones(MK, bool)
    seq = jpg.build_sequential_edges(jnp.asarray(Rs), jnp.asarray(ts_drift),
                                     valid, jnp.asarray(MK))
    loop = jpg.PoseGraphEdges(
        i=jnp.asarray([7], jnp.int32), j=jnp.asarray([0], jnp.int32),
        s=jnp.ones(1), R=jnp.eye(3)[None], t=jnp.asarray(ts[0] - ts[7])[None],
        valid=jnp.asarray([True]), weight=jnp.asarray([5.0]))
    edges = jpg.concat_edges(seq, loop)
    sj, Rj, tj = jpg.optimize_pose_graph(jnp.asarray(Rs),
                                         jnp.asarray(ts_drift), valid, edges,
                                         iters=25)
    st, Rt, tt = tpg.optimize_pose_graph(torch.from_numpy(Rs),
                                         torch.from_numpy(ts_drift),
                                         torch.ones(MK, dtype=torch.bool),
                                         _to_torch_edges(edges), iters=25)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    drift_after = abs(float(tt[7, 0] / st[7]) - ts[7, 0])
    assert drift_after < 0.35 * abs(ts_drift[7, 0] - ts[7, 0])


@pytest.mark.parametrize("iters", [1, 15])
def test_optimize_pose_graph_carried_map(revisit, iters):
    """The essential graph of the carried map (chain + covisibility
    edges) with an injected loop edge from the newest keyframe to the
    first, measuring the current relative pose off by 8% in scale and
    3 degrees: node 0 stays, the loop pulls the rest."""
    m = revisit[1]
    n = int(m["n_kf"])
    kf, cand = n - 1, 0
    Ri, ti = m["kf_R"][kf], m["kf_t"][kf]
    Rc, tc = m["kf_R"][cand], m["kf_t"][cand]
    a = np.deg2rad(3.0)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]], np.float32)
    R_ca = Rz @ Rc @ Ri.T
    t_ca = 1.08 * (tc - Rc @ Ri.T @ ti)
    mj = jmap(m)
    loop = jpg.PoseGraphEdges(
        i=jnp.asarray([kf], jnp.int32), j=jnp.asarray([cand], jnp.int32),
        s=jnp.asarray([1.08], jnp.float32), R=jnp.asarray(R_ca[None]),
        t=jnp.asarray(t_ca[None]), valid=jnp.asarray([True]),
        weight=jnp.asarray([5.0]))
    edges = jpg.concat_edges(jpg.concat_edges(jcov.chain_edges(mj),
                                              jcov.covis_edges(mj)), loop)
    sj, Rj, tj = jpg.optimize_pose_graph(mj.kf_R, mj.kf_t, mj.kf_valid,
                                         edges, iters=iters)
    st, Rt, tt = tpg.optimize_pose_graph(
        torch.from_numpy(m["kf_R"]), torch.from_numpy(m["kf_t"]),
        torch.from_numpy(m["kf_valid"]), _to_torch_edges(edges), iters=iters)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert abs(float(st[kf]) - 1.0) > 1e-3
    np.testing.assert_allclose(tt[0].numpy(), m["kf_t"][0], atol=1e-6)
