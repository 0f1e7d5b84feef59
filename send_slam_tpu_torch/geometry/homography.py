"""Homography decomposition (Faugeras 1988) into 8 motion hypotheses.

Counterpart of ``send_slam_tpu/geometry/homography.py``, batched over
leading dims: H (…,3,3) -> R (…,8,3,3), unit t (…,8,3), in the same
hypothesis order.
"""

from __future__ import annotations

import torch


def _mat3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    Kinv = torch.linalg.inv_ex(K)[0]
    A = Kinv @ H @ K
    U, D, Vt = torch.linalg.svd(A)
    V = Vt.transpose(-1, -2)
    s = (torch.linalg.det(U) * torch.linalg.det(V))[..., None, None]
    d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2]

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    d2s = torch.clamp(d2, min=1e-12)
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    Rs, ts = [], []
    sin_t = (d1 - d3) * x1 * x3 / d2s
    cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = _mat3([[cos_t, zero, -st], [zero, one, zero],
                        [st, zero, cos_t]])
            tp = torch.stack([e1 * x1, zero, -e3 * x3], -1) \
                * (d1 - d3)[..., None]
            Rs.append(s * U @ Rp @ Vt)
            ts.append((U @ tp[..., None])[..., 0])

    sin_p = (d1 + d3) * x1 * x3 / d2s
    cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = _mat3([[cos_p, zero, sp], [zero, -one, zero],
                        [sp, zero, -cos_p]])
            tp = torch.stack([e1 * x1, zero, e3 * x3], -1) \
                * (d1 + d3)[..., None]
            Rs.append(s * U @ Rp @ Vt)
            ts.append((U @ tp[..., None])[..., 0])

    R8 = torch.stack(Rs, -3)
    t8 = torch.stack(ts, -2)
    t8 = t8 / torch.clamp(torch.linalg.norm(t8, dim=-1, keepdim=True),
                          min=1e-12)
    return R8, t8
