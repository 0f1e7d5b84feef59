"""Segment sums and row gathers over a fixed observation -> slot map.

Counterpart of ``send_slam_tpu/ops/segsum.py`` ``ObsMap`` in its
native-scatter form (the ``oh_t is None`` branches): on the card a
scatter-add (``index_add_``) and a row gather are native, so the TPU's
bf16 one-hot matmul forms and their hi/lo splits are not carried over.
Rows whose id equals the slot count L are the spill slot and dropped.

Float scatter-adds on the card run with atomics, so sums may differ from
the CPU's sequential order in the last bits.
"""

from __future__ import annotations

import torch


class ObsMap:
    """R observation rows mapped onto L slots (ids in [0, L])."""

    def __init__(self, ids: torch.Tensor, L: int):
        self.ids = ids.to(torch.int64)
        self.L = L
        self._ok = (self.ids >= 0) & (self.ids < L)
        self._safe = torch.where(self._ok, self.ids,
                                 torch.full_like(self.ids, L))

    def seg_sum(self, values: torch.Tensor) -> torch.Tensor:
        """(R, D) -> (L, D) per-slot sums."""
        out = torch.zeros((self.L + 1, values.shape[-1]), dtype=values.dtype,
                          device=values.device)
        out.index_add_(0, self._safe, values)
        return out[:self.L]

    def seg_sum_t(self, values_t: torch.Tensor) -> torch.Tensor:
        """(D, R) -> (D, L)."""
        return self.seg_sum(values_t.T).T

    def seg_sum_batched_t(self, values: torch.Tensor) -> torch.Tensor:
        """(B, D, Rb) -> (B, D, L) with ids viewed as (B, Rb): one
        segment sum per block."""
        B, D, Rb = values.shape
        ids_b = self._safe.reshape(B, Rb)
        spill = ids_b == self.L
        flat = (torch.arange(B, device=values.device)[:, None] * self.L
                + ids_b)
        flat = torch.where(spill, torch.full_like(flat, B * self.L), flat)
        out = torch.zeros((B * self.L + 1, D), dtype=values.dtype,
                          device=values.device)
        out.index_add_(0, flat.reshape(-1),
                       values.permute(0, 2, 1).reshape(-1, D))
        return out[:B * self.L].reshape(B, self.L, D).permute(0, 2, 1)

    def gather_t(self, table_t: torch.Tensor) -> torch.Tensor:
        """(D, L) -> (D, R); spill rows read zero."""
        out = table_t[:, torch.clamp(self.ids, 0, self.L - 1)]
        return torch.where(self._ok[None, :], out, torch.zeros_like(out))
