"""The port's order-fixed segment sums (``ops/segsum.ObsMap``), which
make BA assembly replay bit for bit on the card, against the
``index_add_`` they replaced, on the CPU. A segment of one or two rows
adds exactly as ``index_add_`` does (float addition commutes); longer
ones are summed in ascending-value order, so they agree to f32 rounding
(1e-6 relative) and do not depend on the order of the rows at all."""

import numpy as np
import pytest
import torch

from send_slam_tpu_torch.ops.segsum import ObsMap

torch.set_num_threads(1)


def index_add_sum(ids, L, values):
    safe = torch.where((ids >= 0) & (ids < L), ids, torch.full_like(ids, L))
    out = torch.zeros((L + 1, values.shape[1]), dtype=values.dtype)
    out.index_add_(0, safe, values)
    return out[:L]


def rows(seed, R=3000, L=400, D=12):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(-1, L + 1, R))
    vals = torch.from_numpy(
        (rng.normal(size=(R, D)) * 10.0 ** rng.uniform(-3, 3, (R, 1)))
        .astype(np.float32))
    return ids, L, vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equal_to_index_add(seed):
    ids, L, vals = rows(seed)
    got = ObsMap(ids, L).seg_sum(vals)
    ref = index_add_sum(ids, L, vals)
    counts = torch.bincount(ids[(ids >= 0) & (ids < L)], minlength=L)
    short = counts <= 2
    assert short.any() and (~short).any()
    assert torch.equal(got[short], ref[short])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6 * float(vals.abs().max()))
    # Small integers add exactly in any order: equal everywhere.
    ints = torch.round(vals.clamp(-50, 50))
    assert torch.equal(ObsMap(ids, L).seg_sum(ints),
                       index_add_sum(ids, L, ints))


@pytest.mark.parametrize("seed", [0, 1])
def test_invariant_to_row_order(seed):
    ids, L, vals = rows(seed)
    base = ObsMap(ids, L).seg_sum(vals)
    perm = torch.from_numpy(np.random.default_rng(seed + 10)
                            .permutation(len(ids)))
    assert torch.equal(ObsMap(ids[perm], L).seg_sum(vals[perm]), base)
    # index_add_ itself is not: long segments change in the last bits.
    assert not torch.equal(index_add_sum(ids[perm], L, vals[perm]),
                           index_add_sum(ids, L, vals))


def test_batched_and_transposed_forms():
    ids, L, vals = rows(3, R=8 * 500, L=300, D=18)
    om = ObsMap(ids, L)
    vb = vals.T.reshape(18, 8, 500).permute(1, 0, 2)      # (B, D, Rb)
    got = om.seg_sum_batched_t(vb)
    for b in range(8):
        one = ObsMap(ids[b * 500:(b + 1) * 500], L).seg_sum(vb[b].T).T
        assert torch.equal(got[b], one)
    assert torch.equal(om.seg_sum_t(vals.T), om.seg_sum(vals).T)
    # Reading the same map twice reuses its segment counts: the same bits.
    assert torch.equal(om.seg_sum_batched_t(vb), got)


@pytest.mark.cuda
def test_card_sums_replay_and_equal_the_cpu():
    """On the card the same sums replay bit for bit and equal the CPU's
    (one sequential accumulator per segment on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ids, L, vals = rows(4, R=20000, L=2000, D=18)
    om = ObsMap(ids.cuda(), L)
    got = om.seg_sum(vals.cuda())
    assert torch.equal(ObsMap(ids.cuda(), L).seg_sum(vals.cuda()), got)
    assert torch.equal(got.cpu(), ObsMap(ids, L).seg_sum(vals))
    vb = vals.cuda().T.reshape(18, 8, 2500).permute(1, 0, 2)
    assert torch.equal(om.seg_sum_batched_t(vb).cpu(),
                       ObsMap(ids, L).seg_sum_batched_t(vb.cpu()))
