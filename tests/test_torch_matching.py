"""Hamming matching of the port against the JAX package (eager, CPU):
distances and match sets are integers / indices and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from send_slam_tpu.ops import hamming as jham
from send_slam_tpu_torch.ops import hamming as tham

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def descriptors(rng, n, base=None, flips=0):
    if base is None:
        d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    else:
        d = base.copy()
        for i in range(n):
            for _ in range(flips):
                w, b = rng.integers(0, 8), rng.integers(0, 32)
                d[i, w] ^= np.uint32(1 << int(b))
    return d


def td(d):
    return T(d.view(np.int32))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    a = descriptors(rng, 300)
    # b: noisy copies of a shuffled subset, plus twins and distractors,
    # so ties, ratio failures and mutual failures all occur.
    perm = rng.permutation(300)[:200]
    b = np.concatenate([descriptors(rng, 200, a[perm], flips=12),
                        descriptors(rng, 40, a[perm[:40]], flips=14),
                        descriptors(rng, 60)])
    va = rng.random(300) < 0.9
    vb = rng.random(300) < 0.9
    ang_a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang_b = np.concatenate([ang_a[perm] + 0.3, rng.uniform(-3, 3, 100)]
                           ).astype(np.float32)
    mask = rng.random((300, 300)) < 0.7
    return a, b, va, vb, ang_a, ang_b, mask


def test_hamming_matrix_exact(data):
    a, b = data[0], data[1]
    j = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    t = tham.hamming_matrix(td(a), td(b)).numpy()
    np.testing.assert_array_equal(j, t)
    assert (t != np.round(t)).sum() == 0


@pytest.mark.parametrize("kw", [
    dict(max_dist=50.0, ratio=0.9, mutual=True),
    dict(max_dist=100.0, ratio=1e9, mutual=True),
    dict(max_dist=50.0, ratio=0.7, mutual=False),
    dict(max_dist=64.0, ratio=0.9, mutual=True, angles=True),
    dict(max_dist=100.0, ratio=1e9, mutual=True, mask=True, return_col=True),
])
def test_match_descriptors_exact(data, kw):
    a, b, va, vb, ang_a, ang_b, mask = data
    kw = dict(kw)
    use_ang = kw.pop("angles", False)
    use_mask = kw.pop("mask", False)
    jkw, tkw = dict(kw), dict(kw)
    if use_ang:
        jkw.update(angles_a=jnp.asarray(ang_a), angles_b=jnp.asarray(ang_b))
        tkw.update(angles_a=T(ang_a), angles_b=T(ang_b))
    if use_mask:
        jkw.update(extra_mask=jnp.asarray(mask))
        tkw.update(extra_mask=T(mask))
    j = jham.match_descriptors(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(va), jnp.asarray(vb), **jkw)
    t = tham.match_descriptors(td(a), td(b), T(va), T(vb), **tkw)
    pairs = zip(j, t) if kw.get("return_col") else [(j, t)]
    for mj, mt in pairs:
        np.testing.assert_array_equal(np.asarray(mj.idx), mt.idx.numpy())
        np.testing.assert_array_equal(np.asarray(mj.dist), mt.dist.numpy())
        np.testing.assert_array_equal(np.asarray(mj.valid), mt.valid.numpy())
    assert (np.asarray(j[0].valid if kw.get("return_col") else j.valid)
            ).sum() > 20


def test_batched_matching_equals_per_row(data):
    a, b, va, vb, ang_a, ang_b, _ = data
    kw = dict(max_dist=64.0, ratio=0.9, mutual=True)
    t = tham.match_descriptors(td(np.stack([a, a[::-1].copy()])), td(b),
                               T(np.stack([va, va[::-1].copy()])), T(vb),
                               angles_a=T(np.stack([ang_a, ang_a[::-1].copy()])),
                               angles_b=T(ang_b), **kw)
    for r, (aa, vv, an) in enumerate([(a, va, ang_a),
                                      (a[::-1].copy(), va[::-1].copy(),
                                       ang_a[::-1].copy())]):
        j = jham.match_descriptors(jnp.asarray(aa), jnp.asarray(b),
                                   jnp.asarray(vv), jnp.asarray(vb),
                                   angles_a=jnp.asarray(an),
                                   angles_b=jnp.asarray(ang_b), **kw)
        np.testing.assert_array_equal(np.asarray(j.idx), t.idx[r].numpy())


def test_rotation_consistency_and_window(data):
    rng = np.random.default_rng(9)
    ang_a = rng.uniform(-3, 3, 80).astype(np.float32)
    ang_b = rng.uniform(-3, 3, 60).astype(np.float32)
    idx = rng.integers(0, 60, 80)
    ok = rng.random(80) < 0.8
    j = jham._rotation_consistent(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                  jnp.asarray(idx), jnp.asarray(ok))
    t = tham._rotation_consistent(T(ang_a), T(ang_b), T(idx), T(ok))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    up = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    uk = rng.uniform(0, 320, (70, 2)).astype(np.float32)
    op = rng.integers(0, 8, 50).astype(np.int32)
    ok_ = rng.integers(0, 8, 70).astype(np.int32)
    gate = rng.random(50) < 0.5
    rad = rng.uniform(5, 60, 50).astype(np.float32)
    j = jham.projection_window_mask(jnp.asarray(up), jnp.asarray(uk),
                                    jnp.asarray(rad), jnp.asarray(op),
                                    jnp.asarray(ok_), 2, jnp.asarray(gate))
    t = tham.projection_window_mask(T(up), T(uk), T(rad), T(op), T(ok_), 2,
                                    T(gate))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
