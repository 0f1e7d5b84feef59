"""Two-view DLT triangulation, batched over leading dims.

Counterpart of ``send_slam_tpu/geometry/triangulate.py``: the
inhomogeneous 3x3 normal-equation form solved by the closed-form
adjugate, elementwise over the batch.
"""

from __future__ import annotations

import torch


def solve3x3_batch(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…,3,3), (…,3) -> (…,3) by the adjugate (singular -> det 1)."""
    a_, b_, c_ = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d_, e_, f_ = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g_, h_, i_ = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A_ = e_ * i_ - f_ * h_
    B_ = c_ * h_ - b_ * i_
    C_ = b_ * f_ - c_ * e_
    D_ = f_ * g_ - d_ * i_
    E_ = a_ * i_ - c_ * g_
    F_ = c_ * d_ - a_ * f_
    G_ = d_ * h_ - e_ * g_
    H_ = b_ * g_ - a_ * h_
    I_ = a_ * e_ - b_ * d_
    det = a_ * A_ + b_ * D_ + c_ * G_
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, torch.ones_like(det))
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (A_ * b0 + B_ * b1 + C_ * b2) * inv_det
    x1 = (D_ * b0 + E_ * b1 + F_ * b2) * inv_det
    x2 = (G_ * b0 + H_ * b1 + I_ * b2) * inv_det
    return torch.stack([x0, x1, x2], -1)


def triangulate_batch(P1, P2, x1, x2):
    """P1, P2: (…,3,4); x1, x2: (…,N,2) pixels -> (…,N,3) points, of
    x1's dtype. The normal equations square the condition of a
    low-parallax pair, so they are formed and solved in float64: in
    float32 the card's and the CPU's matmuls rounded such points up to
    1e-3 m apart."""
    dt = x1.dtype
    P1, P2, x1, x2 = (v.double() for v in (P1, P2, x1, x2))
    rows = []
    for P, x in ((P1, x1), (P2, x2)):
        r2 = P[..., 2, :].unsqueeze(-2)
        rows.append(x[..., 0:1] * r2 - P[..., 0, :].unsqueeze(-2))
        rows.append(x[..., 1:2] * r2 - P[..., 1, :].unsqueeze(-2))
    A = torch.stack(torch.broadcast_tensors(*rows), -2)   # (…,N,4,4)
    M = A[..., :3]
    b = -A[..., 3]
    MtM = M.transpose(-1, -2) @ M \
        + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    Mtb = (M * b[..., None]).sum(-2)
    return solve3x3_batch(MtM, Mtb).to(dt)
