"""The CUDA FAST kernel on the card against its plain PyTorch version.
Marked ``cuda``: these skip without a card. On the GPU machine:
``python -m pytest -q -m cuda tests/test_torch_kernel.py``."""

import numpy as np
import pytest
import torch

from send_slam_tpu_torch.ops import fast, fast_cuda
from send_slam_tpu_torch.ops.pyramid import level_shapes

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
    raw, nms = fast_cuda.fast_score_cuda(img, th, with_nms=True)
    ref = fast.fast_score_map(img, th)
    assert torch.equal(raw, ref)
    assert torch.equal(nms, fast.nms3x3(ref))
    assert torch.equal(fast_cuda.fast_score_cuda(img, th), ref)


def test_batch_rows_equal_single_launches(dev):
    batch = torch.stack([texture(100, 128, seed=s) for s in range(3)]).to(dev)
    raw_b, nms_b = fast.fast_score(batch, 12.0, with_nms=True)
    for r in range(3):
        raw_1, nms_1 = fast.fast_score(batch[r], 12.0, with_nms=True)
        assert torch.equal(raw_b[r], raw_1) and torch.equal(nms_b[r], nms_1)


def test_launch_counter_and_checks(dev):
    img = texture(64, 80, seed=1).to(dev)
    n0 = fast_cuda.launches
    fast.fast_score(img, 7.0)
    fast.fast_score(img, 7.0, with_nms=True)
    assert fast_cuda.launches == n0 + 2
    with pytest.raises(TypeError):
        fast_cuda.fast_score_cuda(img.double(), 7.0)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_cuda(img[:, ::2], 7.0)
    assert fast_cuda.launches == n0 + 2
