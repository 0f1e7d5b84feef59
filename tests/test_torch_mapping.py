"""Map state, local BA, local mapping and covisibility of the port
against the JAX package (eager, CPU) on a seeded synthetic map: six
keyframes along a path observing 300 landmarks plus 100 unmapped points.
Integer state must be equal; float state within the stated tolerances
(summation order of scatter-adds and small matmuls differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from send_slam_tpu.config import MapConfig as JMap, TrackingConfig as JTr
from send_slam_tpu.geometry.se3 import so3_exp as jso3
from send_slam_tpu.models import covisibility as jcov, local_ba as jba
from send_slam_tpu.models import local_mapping as jlm, map_state as jms
from send_slam_tpu.models.frame import Frame as JFrame
from send_slam_tpu.ops.orb import FrameFeatures as JFF
from send_slam_tpu_torch.config import MapConfig as TMap, TrackingConfig as TTr
from send_slam_tpu_torch.models import covisibility as tcov, local_ba as tba
from send_slam_tpu_torch.models import local_mapping as tlm, map_state as tms
from send_slam_tpu_torch.models.frame import Frame as TFrame
from send_slam_tpu_torch.ops.orb import FrameFeatures as TFF

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

MK, ML, N, NKF = 8, 512, 200, 6
FX, FY, CX, CY = 260.0, 260.0, 160.0, 120.0
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)


def _flip(rng, d, n):
    d = d.copy()
    for _ in range(n):
        w, b = rng.integers(0, 8), rng.integers(0, 32)
        d[w] ^= np.uint32(1 << int(b))
    return d


def build(seed=21):
    rng = np.random.default_rng(seed)
    P = np.concatenate([rng.uniform(-3, 3, (400, 2)),
                        rng.uniform(4, 9, (400, 1))], -1)
    base = rng.integers(0, 2 ** 32, (400, 8), dtype=np.uint64).astype(np.uint32)
    m = {k: np.asarray(v) for k, v in
         jms.empty_map(JMap(max_keyframes=MK, max_landmarks=ML), N)
         ._asdict().items()}
    m = {k: np.array(v) for k, v in m.items()}
    poses = []
    for k in range(NKF):
        R = np.asarray(jso3(jnp.asarray([0.0, -0.02 * k, 0.005 * k],
                                        jnp.float32)), np.float64)
        C = np.array([0.25 * k, 0.02 * np.sin(k), 0.05 * k])
        poses.append((R, -R @ C))
    for k, (R, t) in enumerate(poses):
        p = P @ R.T + t
        uv = np.stack([FX * p[:, 0] / p[:, 2] + CX,
                       FY * p[:, 1] / p[:, 2] + CY], -1)
        vis = np.nonzero((uv[:, 0] > 20) & (uv[:, 0] < 300) & (uv[:, 1] > 20)
                         & (uv[:, 1] < 220))[0]
        vis = rng.permutation(vis)[:N - 10]
        slots = rng.permutation(N)[:len(vis)]
        m["kf_uv"][k] = rng.uniform(20, 220, (N, 2))
        m["kf_desc"][k] = rng.integers(0, 2 ** 32, (N, 8),
                                       dtype=np.uint64).astype(np.uint32)
        m["kf_octave"][k] = rng.integers(0, 4, N)
        m["kf_kp_valid"][k] = rng.random(N) < 0.97
        for s, i in zip(slots, vis):
            m["kf_uv"][k, s] = uv[i] + rng.normal(0, 0.5, 2)
            m["kf_desc"][k, s] = _flip(rng, base[i], rng.integers(0, 6))
            if i < 300:
                m["kf_obs_lm"][k, s] = i
        noise = 0.0 if k < 2 else 0.01
        Rn = np.asarray(jso3(jnp.asarray(rng.normal(0, noise, 3),
                                         jnp.float32)), np.float64)
        m["kf_R"][k] = Rn @ R
        m["kf_t"][k] = t + rng.normal(0, noise, 3)
        m["kf_valid"][k] = True
        m["kf_timestamp"][k] = 0.1 * k
    L = 300
    m["lm_pos"][:L] = P[:L] + rng.normal(0, 0.02, (L, 3))
    m["lm_desc"][:L] = base[:L]
    m["lm_valid"][:L] = True
    obs = m["kf_obs_lm"]
    first = np.array([np.nonzero((obs == i).any(1))[0][:1] for i in range(L)],
                     dtype=object)
    m["lm_ref_kf"][:L] = [f[0] if len(f) else 0 for f in first]
    m["lm_visible"][:L] = rng.integers(1, 8, L)
    m["lm_found"][:L] = np.minimum(m["lm_visible"][:L], rng.integers(0, 8, L))
    d = np.linalg.norm(P[:L], axis=1)
    m["lm_normal"][:L] = P[:L] / d[:, None]
    m["lm_dist_max"][:L] = d * 1.2 ** rng.integers(0, 4, L)
    m["lm_dist_min"][:L] = m["lm_dist_max"][:L] / 1.2 ** 7
    m["lm_bit_votes"][:L] = np.asarray(jms.jnp.asarray(
        ((base[:L, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
        .reshape(L, 256)), np.int32)
    m["lm_vote_count"][:L] = 1
    m["n_kf"] = np.asarray(NKF, np.int32)
    return {k: v.astype(np.asarray(getattr(jms.empty_map(JMap(
        max_keyframes=MK, max_landmarks=ML), N), k)).dtype)
        for k, v in m.items()}


@pytest.fixture(scope="module")
def mnp():
    return build()


def jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def tmap(d):
    return tms.map_from_numpy(d, device="cpu")


def as_np(m):
    return tms.map_to_numpy(m) if isinstance(m, tms.MapState) else \
        {k: np.asarray(v) for k, v in m._asdict().items()}


def assert_maps(mj, mt, float_atol=1e-5, rtol=0.0):
    a, b = as_np(mj), as_np(mt)
    for k in a:
        if np.issubdtype(a[k].dtype, np.floating):
            np.testing.assert_allclose(b[k], a[k], atol=float_atol, rtol=rtol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_map_numpy_roundtrip(mnp):
    back = tms.map_to_numpy(tmap(mnp))
    for k in mnp:
        assert back[k].dtype == mnp[k].dtype and back[k].shape == mnp[k].shape
        np.testing.assert_array_equal(back[k], mnp[k])


def test_map_state_ops(mnp):
    rng = np.random.default_rng(3)
    mj, mt = jmap(mnp), tmap(mnp)
    ins = (rng.random(ML) < 0.6, rng.random(ML) < 0.3)
    mj = jms.update_landmark_stats(mj, *map(jnp.asarray, ins))
    mt = tms.update_landmark_stats(mt, *map(torch.from_numpy, ins))
    assert_maps(mj, mt)
    mj, nj = jms.cull_landmarks(mj)
    mt, nt = tms.cull_landmarks(mt)
    assert int(nj) == int(nt) and int(nj) > 0
    assert_maps(mj, mt)
    mj = jms.prune_zero_obs_landmarks(mj)
    mt = tms.prune_zero_obs_landmarks(mt)
    assert_maps(mj, mt)
    # Append a keyframe (a copy of KF 5's table) and new landmarks.
    kf = {k: mnp[k][5] for k in ("kf_uv", "kf_desc", "kf_octave",
                                 "kf_kp_valid")}
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    obs_row = np.full(N, -1, np.int32)
    mj, kj = jms.insert_keyframe(mj, jnp.asarray(R), jnp.asarray(t), 0.7,
                                 *(jnp.asarray(kf[k]) for k in kf),
                                 jnp.asarray(obs_row))
    mt, kt = tms.insert_keyframe(mt, torch.from_numpy(R), torch.from_numpy(t),
                                 0.7, *(torch.from_numpy(np.array(kf[k]).view(
                                     np.int32) if k == "kf_desc" else kf[k])
                                     for k in kf), torch.from_numpy(obs_row))
    assert int(kj) == int(kt) == NKF
    assert_maps(mj, mt, float_atol=1e-6)
    P = 50
    pos = rng.normal(0, 1, (P, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint64).astype(np.uint32)
    good = rng.random(P) < 0.7
    kpa, kpb = rng.permutation(N)[:P], rng.permutation(N)[:P]
    mj, idj = jms.add_landmarks(mj, jnp.asarray(pos), jnp.asarray(desc),
                                jnp.asarray(good), 5, 5, jnp.asarray(kpa),
                                NKF, jnp.asarray(kpb))
    mt, idt = tms.add_landmarks(mt, torch.from_numpy(pos),
                                torch.from_numpy(desc.view(np.int32)),
                                torch.from_numpy(good), 5, 5,
                                torch.from_numpy(kpa), NKF,
                                torch.from_numpy(kpb))
    np.testing.assert_array_equal(np.asarray(idj), idt.numpy())
    assert_maps(mj, mt, float_atol=1e-6)
    mj = jms.refresh_landmarks(mj, jnp.asarray(5), n_levels=4)
    mt = tms.refresh_landmarks(mt, 5, n_levels=4)
    assert_maps(mj, mt, float_atol=1e-5)
    sel = rng.permutation(ML)[:30].astype(np.int32)
    kp = rng.permutation(N)[:30].astype(np.int32)
    vv = rng.random(30) < 0.5
    mj = jms.record_observations(mj, jnp.asarray(NKF), jnp.asarray(sel),
                                 jnp.asarray(kp), jnp.asarray(vv))
    mt = tms.record_observations(mt, NKF, torch.from_numpy(sel),
                                 torch.from_numpy(kp), torch.from_numpy(vv))
    assert_maps(mj, mt, float_atol=1e-5)


@pytest.mark.parametrize("n_fixed,window", [(2, None), (1, None),
                                            (2, "covis")])
def test_local_bundle_adjustment(mnp, n_fixed, window):
    """4 iterations: poses and points within 1e-3 (scatter-add order of
    the Hessian blocks differs, and LM steps amplify it)."""
    mj, mt = jmap(mnp), tmap(mnp)
    kw_j, kw_t = {}, {}
    if window == "covis":
        ij, _ = jcov.covis_window_ids(mj, 6)
        it, _ = tcov.covis_window_ids(mt, 6)
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        kw_j["window_ids"], kw_t["window_ids"] = ij, it
    cfg = dict(max_keyframes=MK, max_landmarks=ML, ba_window=6)
    oj = jba.local_bundle_adjustment(mj, jnp.asarray(K), JMap(**cfg), iters=4,
                                     n_fixed=n_fixed, **kw_j)
    ot = tba.local_bundle_adjustment(mt, torch.from_numpy(K), TMap(**cfg),
                                     iters=4, n_fixed=n_fixed, **kw_t)
    a, b = as_np(oj), as_np(ot)
    for k in ("kf_R", "kf_t", "lm_pos"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-3, err_msg=k)
    assert np.abs(a["lm_pos"] - mnp["lm_pos"]).max() > 1e-3   # it moved
    assert (a["kf_obs_lm"] != b["kf_obs_lm"]).sum() <= 2


def test_local_mapping_steps(mnp):
    mj, mt = jmap(mnp), tmap(mnp)
    Kj, Kt = jnp.asarray(K), torch.from_numpy(K)
    mj2, nj = jlm.create_new_landmarks(mj, jnp.asarray(5), jnp.asarray(3), Kj,
                                       JTr(), n_levels=4)
    mt2, nt = tlm.create_new_landmarks(mt, torch.tensor(5), torch.tensor(3),
                                       Kt, TTr(), n_levels=4)
    assert int(nj) == int(nt) and int(nj) > 10
    # Fresh triangulations from a short baseline: 1e-4 relative.
    assert_maps(mj2, mt2, float_atol=1e-4, rtol=1e-4)
    mj3, fj = jlm.fuse_duplicate_landmarks(mj2, jnp.asarray(5), Kj, JTr())
    mt3, ft = tlm.fuse_duplicate_landmarks(mt2, torch.tensor(5), Kt, TTr())
    assert int(fj) == int(ft)
    assert_maps(mj3, mt3, float_atol=1e-4, rtol=1e-4)


def test_insert_keyframe_with_triangulation(mnp):
    rng = np.random.default_rng(8)
    mj, mt = jmap(mnp), tmap(mnp)
    k = 5                          # the new keyframe re-observes KF 5
    feat = dict(uv=mnp["kf_uv"][k], response=np.ones(N, np.float32),
                octave=mnp["kf_octave"][k], angle=np.zeros(N, np.float32),
                desc=mnp["kf_desc"][k], valid=mnp["kf_kp_valid"][k])
    fj = JFrame(JFF(**{n: jnp.asarray(v) for n, v in feat.items()}),
                jnp.asarray(feat["uv"]), jnp.asarray(0.6, jnp.float32))
    ft = TFrame(TFF(**{n: torch.from_numpy(np.array(v).view(np.int32)
                                           if n == "desc" else np.array(v))
                       for n, v in feat.items()}),
                torch.from_numpy(np.array(feat["uv"])), torch.tensor(0.6))
    obs = mnp["kf_obs_lm"][k]
    match_idx = np.full(ML, N, np.int32)
    match_idx[obs[obs >= 0]] = np.nonzero(obs >= 0)[0]
    inl = (match_idx < N) & (rng.random(ML) < 0.9)
    R = mnp["kf_R"][k] @ np.asarray(jso3(jnp.asarray([0.0, -0.01, 0.0])))
    t = mnp["kf_t"][k] + np.array([-0.1, 0.0, 0.0], np.float32)
    oj = jlm.insert_keyframe_with_triangulation(
        mj, jnp.asarray(R), jnp.asarray(t), fj, jnp.asarray(match_idx),
        jnp.asarray(inl), jnp.asarray(K), JTr(), n_levels=4)
    ot = tlm.insert_keyframe_with_triangulation(
        mt, torch.from_numpy(R.astype(np.float32)), torch.from_numpy(t),
        ft, torch.from_numpy(match_idx).long(), torch.from_numpy(inl),
        torch.from_numpy(K), TTr(), n_levels=4)
    assert int(oj[1]) == int(ot[1]) and int(oj[2]) == int(ot[2])
    assert int(oj[2]) > 0
    assert_maps(oj[0], ot[0], float_atol=1e-4, rtol=1e-4)


def test_covisibility_and_culling(mnp):
    d = dict(mnp)
    d["kf_obs_lm"] = d["kf_obs_lm"].copy()
    d["kf_obs_lm"][3] = d["kf_obs_lm"][2]        # make KF 3 redundant
    mj, mt = jmap(d), tmap(d)
    np.testing.assert_allclose(tcov.keyframe_redundancy(mt).numpy(),
                               np.asarray(jcov.keyframe_redundancy(mj)),
                               atol=1e-6)
    for W in (3, 6):
        np.testing.assert_array_equal(
            np.asarray(jcov.covis_window_ids(mj, W)[0]),
            tcov.covis_window_ids(mt, W)[0].numpy())
    for kw in (dict(), dict(max_cull=2), dict(redundancy_th=0.0,
                                               keep_latest=2, max_cull=1)):
        oj, nj = jcov.cull_redundant_keyframes(mj, **kw)
        ot, nt = tcov.cull_redundant_keyframes(mt, **kw)
        assert int(nj) == int(nt)
        assert_maps(oj, ot)
