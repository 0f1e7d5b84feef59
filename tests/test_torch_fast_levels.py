"""FAST over a whole pyramid in one call (ops/fast.py fast_score_levels,
ops/fast_cuda.py), on the CPU: the dispatcher against the JAX package
and its Pallas kernel (interpret mode), the CUDA launch's tile table,
a transcription of the CUDA kernel's per-pixel formulation against the
plain version, and extract_orb's single call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from send_slam_tpu.ops import fast as jfast, pyramid as jpyr
from send_slam_tpu.ops.pallas.fast_kernel import fast_score_map_pallas
from send_slam_tpu_torch.config import OrbConfig
from send_slam_tpu_torch.ops import fast, fast_cuda, orb, pyramid

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)


def texture(h, w, seed):
    """Boxes of random intensity over uniform noise (many candidates)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(20, 60, (h, w))
    for _ in range(max(40, h * w // 600)):
        y, x = rng.integers(0, max(h - 4, 1)), rng.integers(0, max(w - 4, 1))
        img[y:y + rng.integers(3, 12), x:x + rng.integers(3, 12)] = \
            rng.uniform(40, 250)
    return np.round(img).astype(np.float32)


def boxes(h, w, seed):
    """Boxes over a flat background (few candidates, sharp corners)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 30.0, np.float32)
    for _ in range(60):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y:y + rng.integers(3, 10), x:x + rng.integers(3, 10)] = \
            rng.uniform(40, 250)
    return img


@pytest.mark.parametrize("th", [7.0, 20.0])
def test_levels_equal_plain_jax_and_pallas(th):
    """Each level of a 4-level pyramid of 120x160: the CPU dispatch is
    bit-identical to the port's per-level plain version, to the JAX
    package's fast_score_map / nms3x3, and to the Pallas kernel in
    interpret mode (its raw map over the whole image; its NMS map away
    from the 1-pixel border, where the Pallas kernel compares against
    edge-padded scores instead of -inf)."""
    img = texture(120, 160, seed=5)
    jlevels = jpyr.build_pyramid(jnp.asarray(img), 4, 1.2)
    tlevels = pyramid.build_pyramid(torch.from_numpy(img), 4, 1.2)
    before = fast_cuda.LIBRARY.launches
    got = fast.fast_score_levels(tlevels, th, with_nms=True)
    raw_only = fast.fast_score_levels(tlevels, th)
    assert fast_cuda.LIBRARY.launches == before
    assert len(got) == len(raw_only) == 4
    for lj, lt, (raw, nms), raw2 in zip(jlevels, tlevels, got, raw_only):
        ref = fast.fast_score_map(lt, th)
        assert torch.equal(raw, ref) and torch.equal(raw2, ref)
        assert torch.equal(nms, fast.nms3x3(ref))
        jraw = np.asarray(jfast.fast_score_map(lj, th))
        np.testing.assert_array_equal(raw.numpy(), jraw)
        np.testing.assert_array_equal(nms.numpy(),
                                      np.asarray(jfast.nms3x3(jraw)))
        p_raw = np.asarray(fast_score_map_pallas(lj, th, interpret=True))
        p_nms = np.asarray(fast_score_map_pallas(lj, th, interpret=True,
                                                 with_nms=True))
        np.testing.assert_array_equal(raw.numpy(), p_raw)
        np.testing.assert_array_equal(nms.numpy()[1:-1, 1:-1],
                                      p_nms[1:-1, 1:-1])


def test_levels_batched_rows_equal_single_levels():
    shapes = pyramid.level_shapes(60, 80, 3, 1.2)
    levels = [torch.from_numpy(np.stack([texture(h, w, seed=10 * s + h)
                                         for s in range(3)]))
              for h, w in shapes]
    got = fast.fast_score_levels(levels, 12.0, with_nms=True)
    for lv, (raw, nms) in zip(levels, got):
        assert raw.shape == nms.shape == lv.shape
        for r in range(3):
            ref = fast.fast_score_map(lv[r], 12.0)
            assert torch.equal(raw[r], ref)
            assert torch.equal(nms[r], fast.nms3x3(ref))


def test_levels_refuse_mixed_devices():
    cpu = torch.zeros(16, 16)
    with pytest.raises(ValueError):
        fast.fast_score_levels([cpu, torch.zeros(16, 16, device="meta")], 7.0)
    with pytest.raises(ValueError):     # a CPU list never reaches the kernel
        fast_cuda.fast_score_levels_cuda([cpu], 7.0)


SHAPE_SETS = {
    "640x480_8_levels": pyramid.level_shapes(480, 640, 8, 1.2),
    "7x9": ((7, 9),),
    "100x128": ((100, 128),),
    "ragged_mix": ((7, 9), (100, 128), (33, 65), (1, 1), (64, 64)),
    "tile_multiples": ((64, 128), (32, 64), (96, 192)),
    "one_off_a_tile": ((31, 63), (33, 65), (65, 129)),
    "16_levels": tuple((5 + 13 * i, 3 + 29 * i) for i in range(16)),
}


def block_tile(tiles_x, tile0, block, tile_w, tile_h):
    """(level, x0, y0) of the tile that block ``block`` of the launch
    scores: csrc/fast_kernel.cu's prefix scan over the level table."""
    lvl = 0
    while lvl + 1 < len(tile0) and block >= tile0[lvl + 1]:
        lvl += 1
    t = block - tile0[lvl]
    return lvl, (t % tiles_x[lvl]) * tile_w, (t // tiles_x[lvl]) * tile_h


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
def test_tile_table_covers_every_pixel_once(name):
    """The launch's grid (tile list x batch rows), mapped to tiles by
    the kernel's prefix scan, covers every pixel of every level of every
    batch row exactly once."""
    shapes = SHAPE_SETS[name]
    tw, th = fast_cuda.TILE_W, fast_cuda.TILE_H
    tiles_x, tile0, n_tiles = fast_cuda.tile_table(shapes)
    assert tile0[0] == 0 and len(tiles_x) == len(shapes)
    batch = 2
    cover = [np.zeros((batch, h, w), np.int32) for h, w in shapes]
    for by in range(batch):
        for bx in range(n_tiles):
            lvl, x0, y0 = block_tile(tiles_x, tile0, bx, tw, th)
            h, w = shapes[lvl]
            assert 0 <= x0 < w and 0 <= y0 < h
            cover[lvl][by, y0:y0 + th, x0:x0 + tw] += 1
    for c in cover:
        assert (c == 1).all()


def test_tile_table_refuses_more_than_16_levels():
    with pytest.raises(ValueError):
        fast_cuda.tile_table(((8, 8),) * (fast_cuda.MAX_LEVELS + 1))
    assert fast_cuda.tile_table(((8, 8),) * fast_cuda.MAX_LEVELS)[2] \
        == fast_cuda.MAX_LEVELS


def kernel_formulation(img: torch.Tensor, th: float):
    """csrc/fast_kernel.cu's per-pixel arithmetic, in torch: the compass
    pre-test, the corner test read off the score, arcs by the
    1-2-4-8+1 doubling chain, and the dark side as -(min of maxes).
    Returns the score map and the pre-test's candidate mask."""
    H, W = img.shape
    p = fast._pad2d(img, 3, "replicate")
    d = torch.stack([p[3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W]
                     for dx, dy in fast.CIRCLE_OFFSETS]) - img

    def rolled(x, k):
        return torch.roll(x, -k, 0)

    lo = torch.minimum(d, rolled(d, 1))
    hi = torch.maximum(d, rolled(d, 1))
    lo = torch.minimum(lo, rolled(lo, 2))
    hi = torch.maximum(hi, rolled(hi, 2))
    lo = torch.minimum(lo, rolled(lo, 4))
    hi = torch.maximum(hi, rolled(hi, 4))
    best = torch.minimum(lo, rolled(d, 8)).amax(0)
    worst = torch.maximum(hi, rolled(d, 8)).amin(0)
    m = torch.maximum(best, -worst)
    c4 = d[[0, 4, 8, 12]]
    b, k = c4 > th, c4 < -th
    cand = ((b & torch.roll(b, -1, 0)) | (k & torch.roll(k, -1, 0))).any(0)
    return torch.where(cand & (m > th), m, torch.zeros_like(m)), cand


@pytest.mark.parametrize("kind", ["noise", "boxes", "flat"])
@pytest.mark.parametrize("th", [7.0, 20.0])
def test_kernel_formulation_equals_plain(kind, th):
    img = {"noise": lambda: texture(96, 128, seed=2),
           "boxes": lambda: boxes(96, 128, seed=3),
           "flat": lambda: np.full((96, 128), 77.0, np.float32)}[kind]()
    img = torch.from_numpy(img)
    got, cand = kernel_formulation(img, th)
    ref = fast.fast_score_map(img, th)
    assert torch.equal(got, ref)
    # The pre-test rejects no corner.
    assert not ((ref > 0) & ~cand).any()
    if kind != "flat":
        assert (ref > 0).sum() > 20 and (~cand).sum() > 0


def test_extract_orb_makes_one_fast_call(monkeypatch):
    """extract_orb scores all its levels with one fast_score_levels call
    (one kernel launch per frame on the card)."""
    calls = []
    real = orb.fast_score_levels

    def counting(levels, threshold, with_nms=False):
        calls.append(len(levels))
        return real(levels, threshold, with_nms)

    monkeypatch.setattr(orb, "fast_score_levels", counting)
    cfg = OrbConfig(n_features=300, n_levels=4)
    feats = orb.extract_orb(torch.from_numpy(boxes(120, 160, seed=4)), cfg)
    assert calls == [4]
    assert int(feats.valid.sum()) > 0
