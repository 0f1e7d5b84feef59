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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def segment_counts(seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(R,) segment ids in [0, n_seg] (n_seg = spill) -> (n_seg + 1,)
    row counts (integer adds, exact on any device)."""
    counts = torch.zeros(n_seg + 1, dtype=torch.int64, device=seg.device)
    return counts.index_add_(0, seg, torch.ones_like(seg))


def fixed_order_sum(values: torch.Tensor, seg: torch.Tensor, n_seg: int,
                    counts: torch.Tensor = None) -> torch.Tensor:
    """(R, D) values, (R,) segment ids in [0, n_seg] -> (n_seg, D) sums,
    each in ascending-value order within its segment (spill dropped).
    ``counts``: ``segment_counts(seg, n_seg)``, when the caller keeps it."""
    if counts is None:
        counts = segment_counts(seg, n_seg)
    v, by_value = torch.sort(values, dim=0, stable=True)
    _, by_seg = torch.sort(seg[by_value], dim=0, stable=True)
    v = torch.gather(v, 0, by_seg)
    return torch.segment_reduce(v, "sum", lengths=counts, axis=0,
                                unsafe=True)[:n_seg]


class ObsMap:
    """R observation rows mapped onto L slots (ids in [0, L])."""

    def __init__(self, ids: torch.Tensor, L: int):
        self.ids = ids.to(torch.int64)
        self.L = L
        self._ok = (self.ids >= 0) & (self.ids < L)
        self._safe = torch.where(self._ok, self.ids,
                                 torch.full_like(self.ids, L))
        self._segs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _seg(self, B: int):
        """Segment ids and counts with the rows viewed as B blocks:
        block b's slot l is segment b * L + l."""
        if B not in self._segs:
            R = self._safe.shape[0]
            blk = torch.arange(R, device=self._safe.device) // (R // B)
            seg = torch.where(self._safe == self.L,
                              torch.full_like(self._safe, B * self.L),
                              blk * self.L + self._safe)
            self._segs[B] = (seg, segment_counts(seg, B * self.L))
        return self._segs[B]

    def seg_sum(self, values: torch.Tensor) -> torch.Tensor:
        """(R, D) -> (L, D) per-slot sums."""
        seg, counts = self._seg(1)
        return fixed_order_sum(values, seg, self.L, counts)

    def seg_sum_t(self, values_t: torch.Tensor) -> torch.Tensor:
        """(D, R) -> (D, L)."""
        return self.seg_sum(values_t.T).T

    def seg_sum_batched_t(self, values: torch.Tensor) -> torch.Tensor:
        """(B, D, Rb) -> (B, D, L) with ids viewed as (B, Rb): one
        segment sum per block."""
        B, D, Rb = values.shape
        seg, counts = self._seg(B)
        out = fixed_order_sum(values.permute(0, 2, 1).reshape(-1, D), seg,
                              B * self.L, counts)
        return out.reshape(B, self.L, D).permute(0, 2, 1)

    def gather_t(self, table_t: torch.Tensor) -> torch.Tensor:
        """(D, L) -> (D, R); spill rows read zero."""
        out = table_t[:, torch.clamp(self.ids, 0, self.L - 1)]
        return torch.where(self._ok[None, :], out, torch.zeros_like(out))
