"""Two-view initialization of the port against the JAX package (eager,
CPU) with the JAX package's own RANSAC draws injected: pose within 1e-4,
good-point counts within +-1, the same accept verdict. Minimal-sample
E/H hypotheses come from f32 eigen-solves of ill-conditioned 9x9
systems whose LAPACK differs between the two, so individual hypotheses
differ in the last digits and the comparison is on the selected,
refined motion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from send_slam_tpu.config import (
    CameraConfig as JCam, OrbConfig as JOrb, TrackingConfig as JTr,
)
from send_slam_tpu.models import initializer as jini
from send_slam_tpu.models.frame import make_frame as jmake
from send_slam_tpu.ops.hamming import match_descriptors as jmatch
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.config import (
    CameraConfig as TCam, OrbConfig as TOrb, TrackingConfig as TTr,
)
from send_slam_tpu_torch.models import initializer as tini
from send_slam_tpu_torch.models.frame import make_frame as tmake

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

K = np.array([[260, 0, 160], [0, 260, 120], [0, 0, 1]], np.float32)
CAM = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
ORB = dict(n_features=512, n_levels=4)
# 128 RANSAC hypotheses instead of 512: the same code at a quarter of
# the eager-JAX cost.
TR = dict(init_min_matches=40, init_ransac_iters=128)


@pytest.fixture(scope="module")
def world():
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=50)
    return {k: np.round(w.render(Rs[k], tls[k])).astype(np.float32)
            for k in (0, 1, 2, 4, 6, 12)}


def _frames(world, a, b):
    jf = [jmake(jnp.asarray(world[k]), 0.0, JOrb(**ORB), JCam(**CAM))
          for k in (a, b)]
    tf = [tmake(world[k], 0.0, TOrb(**ORB), TCam(**CAM), device="cpu")
          for k in (a, b)]
    return jf, tf


def _args(f, conv):
    return (conv(f.uv_und), conv(f.feat.desc), conv(f.feat.valid),
            conv(f.feat.angle))


@jax.jit
def _jax_init(fa, fb, key):
    """Jitted, compiled once: eager JAX pays a per-op compile here
    (~30 s); the comparison is on tolerances anyway."""
    return jini.two_view_init(*_args(fa, lambda x: x),
                              *_args(fb, lambda x: x), jnp.asarray(K), key,
                              JTr(**TR))


@pytest.mark.parametrize("a,b,seed,accept", [(2, 6, 1, True),
                                             (4, 12, 2, True),
                                             (0, 1, 3, False)])
def test_two_view_init_with_jax_draws(world, a, b, seed, accept):
    (ja, jb), (ta, tb) = _frames(world, a, b)
    tr = JTr(**TR)
    key = jax.random.PRNGKey(seed)
    jr = _jax_init(ja, jb, key)
    m = jmatch(ja.feat.desc, jb.feat.desc, ja.feat.valid, jb.feat.valid,
               max_dist=float(tr.hamming_th_low), ratio=0.9, mutual=True,
               angles_a=ja.feat.angle, angles_b=jb.feat.angle)
    sets = (torch.from_numpy(np.array(jini._sample_minimal_sets(
                key, m.valid, tr.init_ransac_iters, 8))),
            torch.from_numpy(np.array(jini._sample_minimal_sets(
                jax.random.fold_in(key, 1), m.valid, tr.init_ransac_iters,
                4))))
    tres = tini.two_view_init(*_args(ta, lambda x: x), *_args(tb, lambda x: x),
                              torch.from_numpy(K), TTr(**TR),
                              sets=sets)
    np.testing.assert_array_equal(np.asarray(jr.matches.idx),
                                  tres.matches.idx.numpy())
    assert bool(jr.ok) == bool(tres.ok) == accept
    assert abs(int(jr.n_good) - int(tres.n_good)) <= 1
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jr.R), atol=1e-4)
    if accept:
        # A rejected pair's translation (scaled by a median depth of a
        # handful of near-parallel rays) is ill-conditioned and unused.
        np.testing.assert_allclose(tres.t.numpy(), np.asarray(jr.t),
                                   atol=1e-4)
    # Points of an accepted init: depth error scales as 1/parallax (~1
    # deg here), so the 1e-5 pose agreement becomes ~1e-3 relative in
    # depth. (A rejected pair's handful of points sets a noisy
    # median-depth gauge; its points are discarded anyway.)
    ok = np.asarray(jr.point_ok) & tres.point_ok.numpy()
    if accept:
        np.testing.assert_allclose(tres.points.numpy()[ok],
                                   np.asarray(jr.points)[ok], rtol=5e-3,
                                   atol=1e-3)
    # The reference batch written out: one batched call over two
    # references equals the per-reference calls.
    both = tini.two_view_init(
        *(torch.stack([x, x]) for x in _args(ta, lambda x: x)),
        *_args(tb, lambda x: x), torch.from_numpy(K),
        TTr(**TR), sets=tuple(torch.stack([s, s])
                                             for s in sets))
    for i in range(2):
        np.testing.assert_allclose(both.R[i].numpy(), tres.R.numpy(),
                                   atol=1e-5)
        assert int(both.n_good[i]) == int(tres.n_good)


def test_nanmedian_matches_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 8):
        a = np.full((3, 10), np.nan, np.float32)
        a[:, :n] = rng.normal(size=(3, n))
        a = rng.permuted(a, axis=1)
        j = np.asarray(jnp.nanmedian(jnp.asarray(a), axis=-1))
        t = tini.nanmedian(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(np.isnan(j), np.isnan(t))
        np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)],
                                   rtol=1e-6)


def test_minimal_sets_distinct_and_valid():
    valid = torch.from_numpy(np.random.default_rng(4).random(300) < 0.5)
    g = torch.Generator().manual_seed(0)
    idx = tini.sample_minimal_sets(g, valid, 64, 8)
    assert idx.shape == (64, 8)
    assert bool(valid[idx].all())
    assert all(len(set(r.tolist())) == 8 for r in idx)
