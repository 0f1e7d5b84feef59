"""Segment sums and row gathers over a fixed observation -> slot map.

Counterpart of ``send_slam_tpu/ops/segsum.py`` ``ObsMap`` in its
native form (the ``oh_t is None`` branches): the TPU's bf16 one-hot
matmul forms and their hi/lo splits are not carried over. Rows whose id
equals the slot count L are the spill slot and dropped.

The sums are order-fixed, so a run replays bit for bit on the card: a
float ``index_add_`` there adds with atomics, in whatever order the
threads land. Instead each column's values are sorted, grouped by slot
with a stable sort (so ascending inside every segment), and each
segment is added up left to right by ``torch.segment_reduce`` (one
sequential accumulator per segment, on the CPU and on the card). The
result depends only on the multiset of values in each segment, never
on the order of the rows, and needs no host read. A segment of one or
two rows sums exactly as ``index_add_`` does; longer ones may differ
from it in the last bits.

That is the plain version, which CPU tensors take. CUDA tensors take one
launch of the hand-written kernel (``ops/segsum_cuda.py``,
csrc/segsum_kernel.cu), which gives the same bits from a segment index
and never reads a spill row. A segment map (:class:`SegmentMap`) is built
once per set of ids; its first sum on the card adds the index to it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from send_slam_tpu_torch.ops import segsum_cuda


def segment_counts(seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(R,) segment ids in [0, n_seg] (n_seg = spill) -> (n_seg + 1,)
    row counts (integer adds, exact on any device)."""
    counts = torch.zeros(n_seg + 1, dtype=torch.int64, device=seg.device)
    return counts.index_add_(0, seg, torch.ones_like(seg))


class SegmentIndex(NamedTuple):
    """A segment map's rows in segment order, as the CUDA kernel reads
    them. ``perm`` (R,): the valid rows (ids below n_seg), stably sorted
    by id, then -1 for each spill row; ``offsets`` (n_seg + 1,): where
    each segment starts in ``perm`` (the exclusive cumsum of the counts;
    the last entry is the number of valid rows); ``long_seg``: the
    segments of more than ``segsum_cuda.SHORT`` rows in ascending order,
    the first ``n_long`` (0-dim) of its entries."""
    perm: torch.Tensor
    offsets: torch.Tensor
    long_seg: torch.Tensor
    n_long: torch.Tensor


def _segment_index(seg: torch.Tensor, n_seg: int,
                   counts: torch.Tensor) -> SegmentIndex:
    """The ``SegmentIndex`` of (R,) int64 ids in [0, n_seg] with their
    ``segment_counts``, on their device, without a host read."""
    R = seg.shape[0]
    offsets = torch.zeros(n_seg + 1, dtype=torch.int64, device=seg.device)
    torch.cumsum(counts[:n_seg], 0, out=offsets[1:])
    order = torch.sort(seg, stable=True).indices
    pos = torch.arange(R, device=seg.device)
    valid = pos < offsets[n_seg]
    by_seg = seg[order]
    is_long = valid & (offsets[by_seg] == pos) \
        & (counts[by_seg] > segsum_cuda.SHORT)
    cap = segsum_cuda.long_capacity(R)
    slot = torch.where(is_long, torch.cumsum(is_long, 0) - 1,
                       torch.full_like(pos, cap - 1))
    long_seg = torch.zeros(cap, dtype=torch.int64, device=seg.device)
    long_seg.scatter_(0, slot, by_seg)
    return SegmentIndex(torch.where(valid, order, torch.full_like(order, -1)),
                        offsets, long_seg, is_long.sum())


class SegmentMap:
    """R rows' segment ids ``seg`` (R,) int64 in [0, n_seg] (n_seg: the
    spill slot, dropped) and their ``counts`` (``segment_counts``), built
    once for every sum over the same ids. ``index``: the kernel's
    ``SegmentIndex``, None until the map's first sum on the card builds
    it."""

    def __init__(self, seg: torch.Tensor, n_seg: int):
        self.seg = seg
        self.n_seg = n_seg
        self.counts = segment_counts(seg, n_seg)
        self.index: Optional[SegmentIndex] = None


def fixed_order_sum(values: torch.Tensor, segs: SegmentMap) -> torch.Tensor:
    """(R, D) values over a segment map -> (n_seg, D) sums, each in
    ascending-value order within its segment (spill dropped). Values may
    also be (B, Rb, D), read as R = B * Rb rows block after block. CUDA
    tensors take one launch of the kernel, CPU tensors
    :func:`fixed_order_sum_plain`."""
    if values.is_cuda:
        if segs.index is None:
            segs.index = _segment_index(segs.seg, segs.n_seg, segs.counts)
        return segsum_cuda.segment_sum(values, segs.seg, segs.index,
                                       segs.n_seg)
    return fixed_order_sum_plain(values, segs)


def fixed_order_sum_plain(values: torch.Tensor, segs: SegmentMap
                          ) -> torch.Tensor:
    """The plain PyTorch version of :func:`fixed_order_sum`, op by op on
    any device (the kernel's reference on the card)."""
    values = values.reshape(-1, values.shape[-1])
    v, by_value = torch.sort(values, dim=0, stable=True)
    _, by_seg = torch.sort(segs.seg[by_value], dim=0, stable=True)
    v = torch.gather(v, 0, by_seg)
    return torch.segment_reduce(v, "sum", lengths=segs.counts, axis=0,
                                unsafe=True)[:segs.n_seg]


class ObsMap:
    """R observation rows mapped onto L slots (ids in [0, L])."""

    def __init__(self, ids: torch.Tensor, L: int):
        self.ids = ids.to(torch.int64)
        self.L = L
        self._ok = (self.ids >= 0) & (self.ids < L)
        self._safe = torch.where(self._ok, self.ids,
                                 torch.full_like(self.ids, L))
        self._segs: Dict[int, SegmentMap] = {}

    def _seg(self, B: int) -> SegmentMap:
        """The segment map of the rows viewed as B blocks: block b's slot
        l is segment b * L + l. Built once: the ids do not change across
        a BA's iterations."""
        if B not in self._segs:
            R = self._safe.shape[0]
            blk = torch.arange(R, device=self._safe.device) // (R // B)
            self._segs[B] = SegmentMap(
                torch.where(self._safe == self.L,
                            torch.full_like(self._safe, B * self.L),
                            blk * self.L + self._safe), B * self.L)
        return self._segs[B]

    def seg_sum(self, values: torch.Tensor) -> torch.Tensor:
        """(R, D) -> (L, D) per-slot sums."""
        return fixed_order_sum(values, self._seg(1))

    def seg_sum_t(self, values_t: torch.Tensor) -> torch.Tensor:
        """(D, R) -> (D, L)."""
        return self.seg_sum(values_t.T).T

    def seg_sum_batched_t(self, values: torch.Tensor) -> torch.Tensor:
        """(B, D, Rb) -> (B, D, L) with ids viewed as (B, Rb): one
        segment sum per block."""
        B, D, Rb = values.shape
        out = fixed_order_sum(values.permute(0, 2, 1), self._seg(B))
        return out.reshape(B, self.L, D).permute(0, 2, 1)

    def gather_t(self, table_t: torch.Tensor) -> torch.Tensor:
        """(D, L) -> (D, R); spill rows read zero."""
        out = table_t[:, torch.clamp(self.ids, 0, self.L - 1)]
        return torch.where(self._ok[None, :], out, torch.zeros_like(out))
