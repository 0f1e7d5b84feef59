"""Build and bind the hand-written CUDA segment sum
(csrc/segsum_kernel.cu): one launch computes ``ops/segsum.py``
``fixed_order_sum`` over a segment map's index (``ops/segsum.py``
``SegmentIndex``), bit for bit as the plain version does, reading only
the valid rows.

Built, loaded and launched through ``ops/cuda_build.py``; nothing is
built or loaded at import time. ``LIBRARY.launches`` is the launch
count.
"""

from __future__ import annotations

import ctypes

import torch

from send_slam_tpu_torch.ops.cuda_build import (
    CSRC, CudaLibrary, cuda_device, tensor_ptr,
)

SOURCE = CSRC / "segsum_kernel.cu"
SHORT = 32            # longest segment a thread sorts in registers
SMEM_ROWS = 4096      # longest segment a block sorts in shared memory


def _bind(lib) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.segsum.argtypes = [q, i, q, q, q, q, p, p, p, p, p, p, q, p, p, p]
    lib.segsum.restype = ctypes.c_int


LIBRARY = CudaLibrary("segsum", SOURCE, [f"-DSEGSUM_SHORT={SHORT}",
                                         f"-DSEGSUM_SMEM_ROWS={SMEM_ROWS}"],
                      _bind)


def long_capacity(n_rows: int) -> int:
    """Entries of a segment index's ``long_seg`` over ``n_rows`` rows:
    room for every segment of more than SHORT rows, and one slot the
    index writes the others to."""
    return n_rows // (SHORT + 1) + 1


def _check(x, name, shape, dtype, dev):
    return tensor_ptr("segsum_cuda", x, name, shape, dtype, dev)


def segment_sum(values, seg, index, n_seg: int) -> torch.Tensor:
    """One launch of the segment sum. ``values``: float32 on a CUDA
    device, (R, D), or (B, Rb, D) read as R = B * Rb rows block after
    block; its last two dimensions contiguous either way round (the
    forms ``ObsMap`` hands over: rows, their transpose, and each block's
    transpose). ``seg``: (R,) int64 ids in [0, n_seg], n_seg the spill
    slot; ``index``: their ``segsum.SegmentIndex``. Returns the
    (n_seg, D) sums, contiguous. Launches on the current stream, never
    syncs."""
    dev = cuda_device("segsum_cuda", values)
    if values.dtype != torch.float32:
        raise TypeError(f"segsum_cuda: values must be torch.float32, got "
                        f"{values.dtype}")
    if values.dim() == 2:
        B, (Rb, D) = 1, values.shape
        sb, (sr, sd) = 0, values.stride()
    elif values.dim() == 3:
        B, Rb, D = values.shape
        sb, sr, sd = values.stride()
    else:
        raise ValueError(f"segsum_cuda: values must be (R, D) or (B, Rb, D), "
                         f"got shape {tuple(values.shape)}")
    if not (values.is_contiguous() or values.transpose(-1, -2).is_contiguous()):
        raise ValueError("segsum_cuda: values' last two dimensions must be "
                         "contiguous, as rows or as columns")
    R = B * Rb
    n_seg = int(n_seg)
    i64 = torch.int64
    ptrs = [_check(seg, "seg", (R,), i64, dev),
            _check(index.perm, "perm", (R,), i64, dev),
            _check(index.offsets, "offsets", (n_seg + 1,), i64, dev),
            _check(index.long_seg, "long_seg", (long_capacity(R),), i64, dev),
            _check(index.n_long, "n_long", (), i64, dev)]
    out = torch.zeros((n_seg, D), dtype=torch.float32, device=dev)
    scratch = (torch.empty(R * D, dtype=torch.float32, device=dev)
               if R > SMEM_ROWS else None)
    LIBRARY.launch("segsum", dev, R, D, max(Rb, 1), sb, sr, sd,
                   values.data_ptr() if R else None, *ptrs, n_seg,
                   out.data_ptr() if out.numel() else None,
                   None if scratch is None else scratch.data_ptr())
    return out
