"""The CUDA FAST kernel on the card against its plain PyTorch version.
Marked ``cuda``: these skip without a card. On the GPU machine:
``python -m pytest -q -m cuda tests/test_torch_kernel.py``."""

import numpy as np
import pytest
import torch

from send_slam_tpu_torch.ops import fast, fast_cuda
from send_slam_tpu_torch.ops.pyramid import level_shapes
from send_slam_tpu_torch.utils import profiling

# Several test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def texture(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(20, 60, (h, w))
    for _ in range(max(40, h * w // 600)):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        img[y:y + rng.integers(3, 12), x:x + rng.integers(3, 12)] = \
            rng.uniform(40, 250)
    return torch.from_numpy(np.round(img).astype(np.float32))


@pytest.mark.parametrize("shape", list(level_shapes(480, 640, 8, 1.2))
                         + [(100, 128), (7, 9)])
@pytest.mark.parametrize("th", [7.0, 20.0])
def test_kernel_equals_plain(dev, shape, th):
    img = texture(*shape, seed=sum(shape)).to(dev)
    raw, nms = fast_cuda.fast_score_levels_cuda([img], th, with_nms=True)[0]
    ref = fast.fast_score_map(img, th)
    assert torch.equal(raw, ref)
    assert torch.equal(nms, fast.nms3x3(ref))
    assert torch.equal(fast_cuda.fast_score_levels_cuda([img], th)[0], ref)


def test_batch_rows_equal_single_launches(dev):
    batch = torch.stack([texture(100, 128, seed=s) for s in range(3)]).to(dev)
    raw_b, nms_b = fast.fast_score(batch, 12.0, with_nms=True)
    for r in range(3):
        raw_1, nms_1 = fast.fast_score(batch[r], 12.0, with_nms=True)
        assert torch.equal(raw_b[r], raw_1) and torch.equal(nms_b[r], nms_1)


def test_launch_counter_and_checks(dev):
    img = texture(64, 80, seed=1).to(dev)
    n0 = fast_cuda.LIBRARY.launches
    fast.fast_score(img, 7.0)
    fast.fast_score(img, 7.0, with_nms=True)
    assert fast_cuda.LIBRARY.launches == n0 + 2
    with pytest.raises(TypeError):
        fast_cuda.fast_score_levels_cuda([img.double()], 7.0)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_levels_cuda([img[:, ::2]], 7.0)
    assert fast_cuda.LIBRARY.launches == n0 + 2


def test_failed_launch_raises_and_counts_nothing(dev):
    """A non-zero return of the C entry point (here a batch of 0, which
    it refuses before reading any pointer) raises RuntimeError naming the
    entry and counts no launch, neither the library's nor the tracer's."""
    n0 = fast_cuda.LIBRARY.launches
    profiling.drain()
    profiling.set_tracing(True)
    try:
        with pytest.raises(RuntimeError,
                           match="fast_score_levels launch failed: CUDA "
                                 "error [1-9]"):
            fast_cuda.LIBRARY.launch("fast_score_levels", dev, 1, 0, None,
                                     None, 0, 7.0)
    finally:
        profiling.set_tracing(False)
    assert fast_cuda.LIBRARY.launches == n0
    assert "kernel.fast" not in profiling.drain().counts


def test_kernel_fast_counts_one_per_launch(dev):
    levels = [texture(h, w, seed=i).to(dev) for i, (h, w) in
              enumerate(level_shapes(120, 160, 3, 1.2))]
    n0 = fast_cuda.LIBRARY.launches
    profiling.drain()
    profiling.set_tracing(True)
    try:
        for _ in range(3):
            fast.fast_score_levels(levels, 7.0, with_nms=True)
    finally:
        profiling.set_tracing(False)
    assert fast_cuda.LIBRARY.launches == n0 + 3
    assert profiling.drain().counts.get("kernel.fast") == 3


PYRAMID = list(level_shapes(480, 640, 8, 1.2))


@pytest.mark.parametrize("th", [7.0, 20.0])
@pytest.mark.parametrize("with_nms", [False, True])
def test_one_launch_over_the_pyramid_equals_plain(dev, th, with_nms):
    levels = [texture(h, w, seed=i).to(dev) for i, (h, w) in
              enumerate(PYRAMID + [(100, 128), (7, 9)])]
    n0 = fast_cuda.LIBRARY.launches
    got = fast_cuda.fast_score_levels_cuda(levels, th, with_nms)
    assert fast_cuda.LIBRARY.launches == n0 + 1
    for lv, out in zip(levels, got):
        ref = fast.fast_score_map(lv, th)
        raw = out[0] if with_nms else out
        assert raw.shape == lv.shape and torch.equal(raw, ref)
        if with_nms:
            assert torch.equal(out[1], fast.nms3x3(ref))


def test_fast_score_takes_a_non_contiguous_image(dev):
    img = texture(80, 130, seed=4).to(dev)[:, 1:-1]
    assert not img.is_contiguous()
    raw, nms = fast.fast_score(img, 7.0, with_nms=True)
    ref = fast.fast_score_map(img, 7.0)
    assert torch.equal(raw, ref) and torch.equal(nms, fast.nms3x3(ref))


def test_batch_of_8_pyramids_equals_single_launches(dev):
    levels = [torch.stack([texture(h, w, seed=10 * s + i) for s in range(8)])
              .to(dev) for i, (h, w) in enumerate(PYRAMID)]
    n0 = fast_cuda.LIBRARY.launches
    got = fast_cuda.fast_score_levels_cuda(levels, 7.0, with_nms=True)
    assert fast_cuda.LIBRARY.launches == n0 + 1
    for r in range(8):
        one = fast_cuda.fast_score_levels_cuda(
            [lv[r].contiguous() for lv in levels], 7.0, with_nms=True)
        for (raw_b, nms_b), (raw_1, nms_1) in zip(got, one):
            assert torch.equal(raw_b[r], raw_1) and torch.equal(nms_b[r], nms_1)


def test_levels_wrapper_refuses(dev):
    img = texture(64, 80, seed=1).to(dev)
    batch = torch.stack([img, img])
    refused = [
        ([img] * (fast_cuda.MAX_LEVELS + 1), 7.0, ValueError),
        ([], 7.0, ValueError),
        ([img, img.cpu()], 7.0, ValueError),
        ([batch, torch.stack([img] * 3)], 7.0, ValueError),
        ([batch, img], 7.0, ValueError),
        ([img, img.double()], 7.0, TypeError),
        ([img, img[:, ::2]], 7.0, ValueError),
        ([img], -1.0, ValueError),
        ([img], float("nan"), ValueError),
    ]
    n0 = fast_cuda.LIBRARY.launches
    for levels, th, exc in refused:
        with pytest.raises(exc):
            fast_cuda.fast_score_levels_cuda(levels, th)
    assert fast_cuda.LIBRARY.launches == n0
    assert len(fast_cuda.fast_score_levels_cuda(
        [img] * fast_cuda.MAX_LEVELS, 7.0)) == fast_cuda.MAX_LEVELS


def test_dispatcher_sends_cuda_levels_to_one_launch(dev):
    levels = [texture(h, w, seed=i).to(dev) for i, (h, w) in enumerate(PYRAMID)]
    n0 = fast_cuda.LIBRARY.launches
    got = fast.fast_score_levels(levels, 7.0, with_nms=True)
    assert fast_cuda.LIBRARY.launches == n0 + 1 and len(got) == len(levels)
    with pytest.raises(ValueError):
        fast.fast_score_levels([levels[0], levels[1].cpu()], 7.0)
