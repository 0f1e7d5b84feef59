"""Relocalization of the port against the JAX package on the CPU: the
linear PnP, retrieval scoring, the PnP RANSAC with the JAX package's own
Gumbel-top-k minimal sets injected (JAX threefry draws cannot be
reproduced in torch), and the System's multi-candidate step from a JAX
System's carried map.

Tolerances: R and t to 1e-4 and inliers +-2, as for tracking (the same
f32 formulas; the eigen/SVD solvers and the 6x6 normal equations sum in
another order); retrieval scores to 1e-6 relative (one matvec and two
norms); the accept flag and the winning branch exactly. The port solves
the linear PnP in float64: on exact six-point draws the JAX package's
float32 null vector strays from the exact pose by up to ~4e-3, so there
the port is held to the exact pose at 1e-4 and to the JAX pose within
the JAX pose's own error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import send_slam_tpu.config as jc
import send_slam_tpu_torch.config as tc
from send_slam_tpu.geometry.se3 import se3_exp as jse3_exp
from send_slam_tpu.models import relocalize as jrel
from send_slam_tpu.models import retrieval as jret
from send_slam_tpu.models.system import System as JSystem
from send_slam_tpu.ops.hamming import match_descriptors as jmatch
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.models import relocalize as trel
from send_slam_tpu_torch.models import retrieval as tret
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.map_state import map_from_numpy

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
KM = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
N_FRAMES = 40


def T(x):
    return torch.from_numpy(np.array(x))


def scene(rng, n):
    return rng.uniform([-3, -2, 4], [3, 2, 10], (n, 3)).astype(np.float32)


def gt_pose(xi):
    R, t = jse3_exp(jnp.asarray(xi, jnp.float32))
    return np.asarray(R), np.asarray(t)


def jax_draws(key, valid, n_hyp=256):
    """The minimal sets JAX ``relocalize`` draws from ``key``."""
    g = jax.random.gumbel(key, (n_hyp, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.array(jax.lax.top_k(g, 6)[1])


@pytest.mark.parametrize("n,noise", [(6, 0.0), (40, 0.002)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_dlt(n, noise, seed):
    rng = np.random.default_rng(100 * seed + n)
    X = scene(rng, n)
    R_gt, t_gt = gt_pose([0.2, -0.1, 0.3, 0.1, -0.2, 0.05])
    p = X @ R_gt.T + t_gt
    xn = (p[:, :2] / p[:, 2:3] + rng.normal(0, noise, (n, 2))) \
        .astype(np.float32)
    Rj, tj = (np.asarray(a) for a in jrel._pnp_dlt(jnp.asarray(X),
                                                    jnp.asarray(xn)))
    Rt, tt = trel._pnp_dlt(T(X), T(xn))
    assert Rt.dtype == tt.dtype == torch.float32
    if noise == 0.0:
        np.testing.assert_allclose(Rt.numpy(), R_gt, atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), t_gt, atol=1e-4)
        for a, b, gt in ((Rt.numpy(), Rj, R_gt), (tt.numpy(), tj, t_gt)):
            assert np.abs(a - b).max() <= np.abs(b - gt).max() + 1e-4
    else:
        np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), tj, atol=1e-4)
    # A leading batch dim (the JAX package's vmap) gives the same rows.
    Rb, tb = trel._pnp_dlt(T(np.stack([X, X[::-1]])),
                           T(np.stack([xn, xn[::-1]])))
    np.testing.assert_allclose(Rb[0].numpy(), Rt.numpy(), atol=1e-5)
    np.testing.assert_allclose(tb[1].numpy(), tt.numpy(), atol=1e-4)


def test_retrieval_scores_and_idf():
    rng = np.random.default_rng(3)
    MK, N = 24, 300
    desc = rng.integers(0, 2 ** 32, (MK, N, 8), dtype=np.uint64) \
        .astype(np.uint32)
    # Shared texture between neighbours, so buckets repeat across rows.
    desc[1::2, :150] = desc[0::2, :150]
    valid = rng.random((MK, N)) < 0.9
    sigs = np.stack([np.asarray(jret.frame_signature(jnp.asarray(d),
                                                     jnp.asarray(v)))
                     for d, v in zip(desc, valid)])
    kf_valid = rng.random(MK) < 0.8
    q = sigs[5]
    idf_j = np.asarray(jret.idf_weights(jnp.asarray(sigs),
                                        jnp.asarray(kf_valid)))
    idf_t = tret.idf_weights(T(sigs), T(kf_valid)).numpy()
    np.testing.assert_allclose(idf_t, idf_j, rtol=1e-6)
    for idf in (None, idf_j):
        sj = np.asarray(jret.retrieval_scores(
            jnp.asarray(sigs), jnp.asarray(q),
            idf=None if idf is None else jnp.asarray(idf)))
        st = tret.retrieval_scores(T(sigs), T(q),
                                   idf=None if idf is None else T(idf))
        np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("structured", [True, False])
def test_relocalize_with_jax_draws(structured):
    rng = np.random.default_rng(5)
    n_lm, n_extra = 250, 150
    X = scene(rng, n_lm)
    R_gt, t_gt = gt_pose([0.4, 0.2, -0.1, 0.1, -0.15, 0.08])
    p = X @ R_gt.T + t_gt
    uv = np.stack([FX * p[:, 0] / p[:, 2] + CX,
                   FY * p[:, 1] / p[:, 2] + CY], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    if not structured:            # no geometry: every hypothesis fails
        uv = rng.uniform([0, 0], [640, 480], uv.shape)
    lm_desc = rng.integers(0, 2 ** 32, (n_lm, 8), dtype=np.uint64) \
        .astype(np.uint32)
    kp_desc = np.concatenate([lm_desc, rng.integers(
        0, 2 ** 32, (n_extra, 8), dtype=np.uint64).astype(np.uint32)])
    kp_uv = np.concatenate(
        [uv, rng.uniform([0, 0], [640, 480], (n_extra, 2))]) \
        .astype(np.float32)
    lm_valid = np.ones(n_lm, bool)
    kp_valid = np.ones(n_lm + n_extra, bool)
    cfg_j, cfg_t = jc.TrackingConfig(), tc.TrackingConfig()
    key = jax.random.PRNGKey(0)
    rj = jrel.relocalize(jnp.asarray(X), jnp.asarray(lm_desc),
                         jnp.asarray(lm_valid), jnp.asarray(kp_uv),
                         jnp.asarray(kp_desc), jnp.asarray(kp_valid),
                         jnp.asarray(KM), key, cfg_j)
    mj = jmatch(jnp.asarray(lm_desc), jnp.asarray(kp_desc),
                jnp.asarray(lm_valid), jnp.asarray(kp_valid),
                max_dist=float(cfg_j.hamming_th_low), ratio=0.9, mutual=True)
    idx = jax_draws(key, np.asarray(mj.valid))
    rt = trel.relocalize(T(X), T(lm_desc.view(np.int32)), T(lm_valid),
                         T(kp_uv), T(kp_desc.view(np.int32)), T(kp_valid),
                         T(KM), cfg_t, sample_idx=T(idx))
    assert bool(rt.ok) == bool(rj.ok) == structured
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    if structured:
        np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
        np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
        np.testing.assert_allclose(rt.R.numpy(), R_gt, atol=5e-3)
    # Without injected draws the port samples from its own generator.
    g = torch.Generator().manual_seed(0)
    own = trel.relocalize(T(X), T(lm_desc.view(np.int32)), T(lm_valid),
                          T(kp_uv), T(kp_desc.view(np.int32)), T(kp_valid),
                          T(KM), cfg_t, generator=g)
    assert bool(own.ok) == structured


@pytest.fixture(scope="module")
def carried():
    """A JAX System (the small configuration of test_torch_system.py)
    run over 40 frames, and the images."""
    from test_torch_system import engine_cfg
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=N_FRAMES)
    imgs = [np.round(w.render(Rs[k], tls[k])).astype(np.uint8)
            for k in range(N_FRAMES)]
    s = JSystem(engine_cfg(jc))
    for k in range(N_FRAMES):
        s.track_monocular(imgs[k], float(ts[k]))
    assert int(s.map.n_kf) >= 4
    return s, tsys.System(engine_cfg(tc), device="cpu"), imgs


@pytest.mark.parametrize("kidnapped", [False, True])
def test_reloc_step_from_carried_map(carried, kidnapped):
    """Retrieval candidates win on a frame of mapped territory; with
    every keyframe pose turned away from the scene, their re-tracks
    starve and the PnP RANSAC wins (on a frame where its prior-free
    matches hold enough structure: 19 inliers)."""
    s, port, imgs = carried
    m_np = {f: np.array(v) for f, v in s.map._asdict().items()}
    if kidnapped:
        m_np["kf_t"] = m_np["kf_t"] + np.float32(5.0)
    mj = s.map._replace(kf_t=jnp.asarray(m_np["kf_t"]))
    tr = s.cfg.tracking
    key = jax.random.PRNGKey(4)
    img = imgs[30 if kidnapped else 12]
    jf = s._make_frame(jnp.asarray(img, jnp.float32), 0.5)
    out, _ = s._reloc_step(mj, jf, key)
    # The JAX step's own pieces, to read which branch it took.
    pnp = jax.jit(lambda *a: jrel.relocalize(*a, tr))(
        mj.lm_pos, mj.lm_desc, mj.lm_valid, jf.uv_und, jf.feat.desc,
        jf.feat.valid, s._K, key)
    jax_pnp = bool(pnp.ok) and int(pnp.n_inliers) == int(out.n_inliers) \
        and np.allclose(np.asarray(pnp.R), np.asarray(out.R), atol=1e-5)
    mm = jmatch(mj.lm_desc, jf.feat.desc, mj.lm_valid, jf.feat.valid,
                max_dist=float(tr.hamming_th_low), ratio=0.9, mutual=True)
    idx = jax_draws(key, np.asarray(mm.valid))

    tf = port._make_frame(img, 0.5)
    pt, score = port._reloc_step(map_from_numpy(m_np, device="cpu"), tf,
                                 sample_idx=T(idx))
    assert bool(pt.use_pnp) == jax_pnp == kidnapped
    assert abs(int(pt.n_inliers) - int(out.n_inliers)) <= 2
    assert int(pt.n_inliers) >= (15 if kidnapped else tr.reloc_min_matches)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(out.R), atol=1e-4)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(out.t), atol=1e-4)
    assert 0.0 < float(score) <= 1.0 + 1e-6


@pytest.mark.parametrize("max_atlas_maps", [0, 4])
def test_atlas_freeze(max_atlas_maps):
    """Relocalization that keeps failing freezes the map and starts
    afresh, keeping the trajectory (as the JAX package does). With
    ``max_atlas_maps = 0`` the frozen map is dropped; otherwise it is
    kept in the atlas."""
    import dataclasses
    from test_torch_system import engine_cfg
    cfg = engine_cfg(tc)
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, atlas_reloc_patience=2, atlas_min_kf=2,
        max_atlas_maps=max_atlas_maps))
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=N_FRAMES)
    s = tsys.System(cfg, device="cpu")
    for k in range(N_FRAMES):
        s.track_monocular(np.round(w.render(Rs[k], tls[k])).astype(np.uint8),
                          float(ts[k]))
    assert int(s.map.n_kf) > 5
    mapped = s.map
    traj = s.trajectory()
    blank = np.full((240, 320), 20, np.uint8)
    feed = (s.track_monocular(blank, float(ts[-1]) + 0.03 * i)
            for i in range(1, 40))
    while s.state != tsys.TRACKING_NO_IMAGES_YET:
        next(feed)
    assert int(s.map.n_kf) == 0 and s._reloc_failures == 0
    if max_atlas_maps:
        assert len(s.atlas) == 1
        assert int(s.atlas[0].n_kf) >= int(mapped.n_kf)
        assert s.atlas[0].kf_valid.device.type == "cpu"
    else:
        assert s.atlas == []
    kept = [t for t, _, _ in s.trajectory()]
    assert kept[:len(traj)] == [t for t, _, _ in traj]
    assert s._t0 == float(ts[0])
