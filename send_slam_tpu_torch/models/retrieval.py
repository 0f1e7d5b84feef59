"""Place recognition: frame signatures and their retrieval scores.

Counterpart of ``send_slam_tpu/models/retrieval.py``: each 256-bit
descriptor is hashed by 10 seeded hyperplanes into one of 1024 buckets;
a frame's signature is the L2-normalized sqrt-histogram, and a query is
scored against every keyframe's signature as a cosine, optionally
weighted by the live keyframe table's inverse document frequency.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from send_slam_tpu_torch.ops.hamming import unpack_bits

N_PLANES = 10
N_BUCKETS = 1 << N_PLANES


@functools.lru_cache(maxsize=None)
def _hyperplanes(seed: int = 7, n_planes: int = N_PLANES) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(256, n_planes)).astype(np.float32)


def frame_signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) descriptors + (N,) validity -> (N_BUCKETS,) signature."""
    bits = unpack_bits(desc) * 2.0 - 1.0
    planes = torch.from_numpy(_hyperplanes()).to(desc.device)
    hash_bits = (bits @ planes > 0).to(torch.int64)
    weights = torch.ones(N_PLANES, dtype=torch.int64, device=desc.device) \
        << torch.arange(N_PLANES, device=desc.device)
    bucket = (hash_bits * weights).sum(1)
    idx = torch.where(valid, bucket, torch.full_like(bucket, N_BUCKETS))
    hist = torch.zeros(N_BUCKETS + 1, dtype=torch.float32, device=desc.device)
    hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    hist = torch.sqrt(hist[:N_BUCKETS])
    return hist / torch.clamp(torch.linalg.norm(hist), min=1e-9)


def retrieval_scores(signatures: torch.Tensor, query: torch.Tensor,
                     idf: torch.Tensor = None) -> torch.Tensor:
    """(MK, N_BUCKETS) database vs (N_BUCKETS,) query -> (MK,) cosine,
    with ``idf`` (N_BUCKETS,) weights when given."""
    if idf is None:
        return signatures @ query
    wq = query * idf
    wk = signatures * idf[None, :]
    num = wk @ wq
    den = torch.linalg.norm(wk, dim=1) * torch.clamp(
        torch.linalg.norm(wq), min=1e-9)
    return num / torch.clamp(den, min=1e-9)


def idf_weights(signatures: torch.Tensor,
                kf_valid: torch.Tensor) -> torch.Tensor:
    """(MK, N_BUCKETS) signatures + (MK,) validity -> (N_BUCKETS,)
    inverse-document-frequency weights over the live keyframes."""
    present = (signatures > 0) & kf_valid[:, None]
    df = present.to(torch.float32).sum(0)
    n = torch.clamp(kf_valid.to(torch.float32).sum(), min=1.0)
    return torch.log1p(n / (1.0 + df))
