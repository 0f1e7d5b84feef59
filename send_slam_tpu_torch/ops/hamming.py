"""Hamming-distance descriptor matching.

Counterpart of ``send_slam_tpu/ops/hamming.py``. The distance matrix is
popcount(a) + popcount(b) - 2 <bits(a), bits(b)> with the dot as one
float32 matmul of unpacked {0,1} bits: exact integers (<= 256) as long
as TF32 is off, which ``device.py`` guarantees. Match post-processing
(ratio, mutual, rotation histogram) is dense masked argmin work; argmin
and the stable top-k break ties towards the lower index like JAX.
Leading batch dims are allowed throughout (the init's reference batch).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

INVALID_DIST = 1e9
N_ROT_BINS = 30  # ORBmatcher HISTO_LENGTH


def unpack_bits(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(…, N, 8) 32-bit words -> (…, N, 256) {0,1} in ``dtype``."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(dtype)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(…, N, 8), (…, M, 8) -> (…, N, M) float32 Hamming distances."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    dot = a @ b.transpose(-1, -2)
    return a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :] - 2.0 * dot


class Matches(NamedTuple):
    idx: torch.Tensor    # (…, N) int64 column index in B, -1 if unmatched
    dist: torch.Tensor   # (…, N) float32
    valid: torch.Tensor  # (…, N) bool


def _rotation_consistent(angles_a, angles_b, best_idx, ok):
    """ORBmatcher CheckOrientation: keep matches whose angle delta lies
    in the 3 fullest of 30 histogram bins."""
    from send_slam_tpu_torch.ops.orb import stable_topk
    angles_b = angles_b.expand(best_idx.shape[:-1] + angles_b.shape[-1:])
    da = angles_a - torch.gather(angles_b, -1, best_idx)
    da = torch.remainder(da, 2 * math.pi)
    bins = torch.floor(da / (2 * math.pi) * N_ROT_BINS).to(torch.int64)
    bins = torch.clamp(bins, 0, N_ROT_BINS - 1)
    onehot = torch.nn.functional.one_hot(bins, N_ROT_BINS).to(torch.float32)
    counts = (onehot * ok[..., None].to(torch.float32)).sum(-2)
    _, top3 = stable_topk(counts, 3)
    return (bins[..., :, None] == top3[..., None, :]).any(-1)


def match_descriptors(desc_a, desc_b, valid_a, valid_b,
                      max_dist: float = 100.0, ratio: float = 0.9,
                      mutual: bool = True,
                      extra_mask: Optional[torch.Tensor] = None,
                      angles_a=None, angles_b=None,
                      return_col: bool = False):
    """Best match A -> B with distance / ratio / mutual / rotation
    tests; with ``return_col`` also the column view of the 1-1 set."""
    m = valid_a[..., :, None] & valid_b[..., None, :]
    if extra_mask is not None:
        m = m & extra_mask
    d = torch.where(m, hamming_matrix(desc_a, desc_b),
                    torch.full((), INVALID_DIST, device=desc_a.device))
    N, M = d.shape[-2], d.shape[-1]
    best = d.amin(-1)
    best_idx = torch.argmin(d, dim=-1)
    if ratio < 1e6:
        cols = torch.arange(M, device=d.device)
        d2 = torch.where(cols == best_idx[..., None],
                         torch.full((), INVALID_DIST, device=d.device), d)
        second = d2.amin(-1)
        ok = (best <= max_dist) & (best < ratio * second)
    else:
        ok = best <= max_dist

    rows = torch.arange(N, device=d.device)
    back = torch.argmin(d, dim=-2) if mutual or return_col else None
    if mutual:
        ok = ok & (torch.gather(back, -1, best_idx) == rows)
    if angles_a is not None and angles_b is not None:
        ok = ok & _rotation_consistent(angles_a, angles_b, best_idx, ok)

    minus1 = torch.full_like(best_idx, -1)
    inval = torch.full_like(best, INVALID_DIST)
    row = Matches(idx=torch.where(ok, best_idx, minus1),
                  dist=torch.where(ok, best, inval), valid=ok)
    if not return_col:
        return row
    assert mutual, "column view is defined by the mutual 1-1 match set"
    cols = torch.arange(M, device=d.device)
    col_ok = torch.gather(ok, -1, back) & (
        torch.gather(best_idx, -1, back) == cols)
    col = Matches(idx=torch.where(col_ok, back, torch.full_like(back, -1)),
                  dist=torch.where(col_ok, torch.gather(best, -1, back),
                                   torch.full_like(col_ok, INVALID_DIST,
                                                   dtype=best.dtype)),
                  valid=col_ok)
    return row, col


def projection_window_mask(uv_pred, uv_kp, radius, octave_pred=None,
                           octave_kp=None, octave_slack: int = 1,
                           octave_gate=None) -> torch.Tensor:
    """(N, 2) predictions x (M, 2) keypoints -> (N, M) bool: within
    ``radius`` (scalar or per-row) and the octave window where gated."""
    d2 = ((uv_pred[:, None, :] - uv_kp[None, :, :]) ** 2).sum(-1)
    r2 = torch.as_tensor(radius, dtype=d2.dtype, device=d2.device) ** 2
    if r2.dim() == 1:
        r2 = r2[:, None]
    m = d2 <= r2
    if octave_pred is not None and octave_kp is not None:
        dlvl = (octave_pred[:, None] - octave_kp[None, :]).abs()
        ok = dlvl <= octave_slack
        if octave_gate is not None:
            ok = ok | ~octave_gate[:, None]
        m = m & ok
    return m
