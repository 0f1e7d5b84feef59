"""The hand-written CUDA FAST-16 kernel (csrc/fast_kernel.cu): its build
and its wrapper.

Built, loaded and launched through ``ops/cuda_build.py``; nothing is
built or loaded at import time. ``LIBRARY.report()`` is nvcc's register
and shared-memory report, ``LIBRARY.launches`` the launch count.

One launch scores every level of a pyramid, and every row of a batch:
:func:`fast_score_levels_cuda`. The tile table that maps the launch's
1-D grid onto the levels is computed here (:func:`tile_table`) and
checked again by the C entry point.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from send_slam_tpu_torch.ops.cuda_build import (
    CSRC, CudaLibrary, cuda_device, tensor_ptr,
)

SOURCE = CSRC / "fast_kernel.cu"
MAX_LEVELS = 16       # entries of the kernel's level table
# The kernel's tile, chosen on the card (PERF.md section 6); the build
# passes it to csrc/fast_kernel.cu, and tile_table uses it.
TILE_W, TILE_H = 64, 32


def _bind(lib) -> None:
    lib.fast_score_levels.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.fast_score_levels.restype = ctypes.c_int


LIBRARY = CudaLibrary("fast", SOURCE, [f"-DFAST_TILE_W={TILE_W}",
                                       f"-DFAST_TILE_H={TILE_H}"], _bind)


def tile_table(shapes: Tuple[Tuple[int, int], ...]
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
    """Tiles (TILE_W x TILE_H) across each level, each level's first tile
    in the launch's 1-D tile list, and the tile count of all levels
    together."""
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"{len(shapes)} levels: the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    tiles_x, tile0, n = [], [], 0
    for h, w in shapes:
        if h < 1 or w < 1:
            raise ValueError(f"empty level {h}x{w}")
        tiles_x.append(math.ceil(w / TILE_W))
        tile0.append(n)
        n += tiles_x[-1] * math.ceil(h / TILE_H)
    return tuple(tiles_x), tuple(tile0), n


@functools.lru_cache(maxsize=64)
def _dims(shapes):
    tiles_x, tile0, n_tiles = tile_table(shapes)
    flat = [v for (h, w), tx, t0 in zip(shapes, tiles_x, tile0)
            for v in (h, w, tx, t0)]
    return (ctypes.c_int * len(flat))(*flat), n_tiles


def fast_score_levels_cuda(levels: Sequence[torch.Tensor], threshold: float,
                           with_nms: bool = False):
    """FAST scores of every level in ``levels`` in one kernel launch.

    ``levels``: up to 16 contiguous float32 CUDA tensors on one device,
    each (H, W), or each (B, H, W) with the same B. Returns one raw map
    per level, or one (raw, nms) pair per level with ``with_nms``; each
    is a view, in its level's shape, into one buffer for all levels.
    Launches on the current stream, never syncs."""
    levels = list(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels: the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    first = levels[0]
    dev = cuda_device("fast_score_levels_cuda", first)
    ptrs = []
    for i, lv in enumerate(levels):
        ptrs.append(tensor_ptr("fast_score_levels_cuda", lv, f"levels[{i}]",
                               None, torch.float32, dev))
        if lv.dim() != first.dim() or lv.dim() not in (2, 3):
            raise ValueError("levels must all be (H, W) or all (B, H, W)")
        if lv.dim() == 3 and lv.shape[0] != first.shape[0]:
            raise ValueError("levels must share one batch size")
        if lv.numel() == 0:
            raise ValueError(f"empty level {tuple(lv.shape)}")
    if not threshold >= 0.0:
        raise ValueError(f"threshold must be >= 0, got {threshold}")
    B = first.shape[0] if first.dim() == 3 else 1
    dims, n_tiles = _dims(tuple((lv.shape[-2], lv.shape[-1])
                                for lv in levels))
    offsets = [0]
    for lv in levels:
        offsets.append(offsets[-1] + lv.numel())
    raw = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    nms = torch.empty_like(raw) if with_nms else None
    for buf in (raw, nms):
        base = buf.data_ptr() if buf is not None else None
        ptrs += [base + 4 * o if base is not None else None
                 for o in offsets[:-1]]
    LIBRARY.launch("fast_score_levels", dev, len(levels), B,
                   (ctypes.c_void_p * len(ptrs))(*ptrs), dims, n_tiles,
                   float(threshold))
    # One as_strided view per level (half the host time of split + view).
    raws = [raw.as_strided(lv.shape, lv.stride(), o)
            for lv, o in zip(levels, offsets)]
    if not with_nms:
        return raws
    return list(zip(raws, [nms.as_strided(lv.shape, lv.stride(), o)
                           for lv, o in zip(levels, offsets)]))
