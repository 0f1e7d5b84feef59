"""Two-view geometry: normalized 8-point F and E, homography DLT, Sampson and
transfer errors, and the Sampson Gauss-Newton refinement of (R, t).

Counterpart of ``send_slam_tpu/geometry/epipolar.py``. Every function
takes leading batch dims (RANSAC hypotheses, init references), which is
how the JAX package's ``vmap`` over hypotheses is written out here.
"""

from __future__ import annotations

import math

import torch

from send_slam_tpu_torch.geometry.se3 import hat, so3_exp


def _normalize_points(x, w=None):
    """Hartley normalization of (…,N,2), optional weights (…,N).
    Returns (xn, T) with xn = (T @ [x;1])[:2]."""
    if w is None:
        mean = x.mean(-2)
        d = torch.sqrt(((x - mean[..., None, :]) ** 2).sum(-1))
        mean_d = d.mean(-1)
    else:
        wsum = torch.clamp(w.sum(-1), min=1e-8)
        mean = (x * w[..., None]).sum(-2) / wsum[..., None]
        d = torch.sqrt(((x - mean[..., None, :]) ** 2).sum(-1))
        mean_d = (d * w).sum(-1) / wsum
    scale = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-8)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    xn = (x - mean[..., None, :]) * scale[..., None, None]
    return xn, T


def _smallest_singular_vector(A):
    """Right-singular vector of (…,R,C) A for its smallest singular
    value: eigh of A^T A, then two shifted inverse-iteration steps."""
    AtA = A.transpose(-1, -2) @ A
    w, v = torch.linalg.eigh(AtA)
    x = v[..., :, 0]
    n = AtA.shape[-1]
    s = w[..., 0] - 1e-6 * torch.clamp(w[..., -1], min=1e-12)
    M = AtA - s[..., None, None] * torch.eye(n, dtype=A.dtype,
                                             device=A.device)
    for _ in range(2):
        x = torch.linalg.solve_ex(M, x[..., None])[0][..., 0]
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                            min=1e-20)
    return x


def _epipolar_rows(x1h, x2h):
    u1, v1 = x1h[..., 0], x1h[..., 1]
    u2, v2 = x2h[..., 0], x2h[..., 1]
    ones = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                        u1, v1, ones], -1)


def eight_point_fundamental(x1, x2, weights=None):
    """Normalized 8-point F from (…,N>=8,2) pixel pairs, optional weights
    (…,N): rank 2 enforced, denormalized, f33-normalized."""
    x1n, T1 = _normalize_points(x1, weights)
    x2n, T2 = _normalize_points(x2, weights)
    A = _epipolar_rows(x1n, x2n)
    if weights is not None:
        A = A * weights[..., None]
    f = _smallest_singular_vector(A)
    U, S, Vt = torch.linalg.svd(f.reshape(f.shape[:-1] + (3, 3)))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = T2.transpose(-1, -2) @ ((U * S[..., None, :]) @ Vt) @ T1
    f33 = F[..., 2, 2]
    f33 = torch.where(f33.abs() < 1e-10, torch.ones_like(f33), f33)
    return F / f33[..., None, None]


def eight_point_essential(x1n, x2n, weights=None):
    """8-point ESSENTIAL matrix on K-normalized coords, projected onto
    the essential manifold (s, s, 0), Frobenius-normalized."""
    x1h, T1 = _normalize_points(x1n, weights)
    x2h, T2 = _normalize_points(x2n, weights)
    A = _epipolar_rows(x1h, x2h)
    if weights is not None:
        A = A * weights[..., None]
    e = _smallest_singular_vector(A)
    E = T2.transpose(-1, -2) @ e.reshape(e.shape[:-1] + (3, 3)) @ T1
    U, S, Vt = torch.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    diag = torch.stack([s, s, torch.zeros_like(s)], -1)
    E = (U * diag[..., None, :]) @ Vt
    n = torch.linalg.norm(E, dim=(-2, -1))
    n = torch.where(n < 1e-12, torch.ones_like(n), n)
    return E / n[..., None, None]


def homography_dlt(x1, x2, weights=None):
    """DLT homography x2 ~ H x1 from (…,N,2) pairs, h33-normalized."""
    x1n, T1 = _normalize_points(x1, weights)
    x2n, T2 = _normalize_points(x2, weights)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    zeros = torch.zeros_like(u1)
    ones = torch.ones_like(u1)
    r1 = torch.stack([zeros, zeros, zeros, -u1, -v1, -ones,
                      v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, ones, zeros, zeros, zeros,
                      -u2 * u1, -u2 * v1, -u2], -1)
    A = torch.cat([r1, r2], -2)
    if weights is not None:
        A = A * torch.cat([weights, weights], -1)[..., None]
    h = _smallest_singular_vector(A)
    H = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.solve_ex(T2, H @ T1)[0]
    h33 = H[..., 2, 2]
    h33 = torch.where(h33.abs() < 1e-10, torch.ones_like(h33), h33)
    return H / h33[..., None, None]


def _sampson_parts(F, x1, x2):
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], -1)                   # (…,N,3)
    p2 = torch.cat([x2, ones], -1)
    Fx1 = p1 @ F.transpose(-1, -2)
    Ftx2 = p2 @ F
    num = (p2 * Fx1).sum(-1)
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    return num, den


def sampson_error(F, x1, x2):
    """Sampson distance^2 per correspondence: F (…,3,3), x (…,N,2)."""
    num, den = _sampson_parts(F, x1, x2)
    return num ** 2 / torch.clamp(den, min=1e-12)


def sampson_residual(F, x1, x2):
    num, den = _sampson_parts(F, x1, x2)
    return num / torch.sqrt(torch.clamp(den, min=1e-12))


def sampson_cost(R, t, x1n, x2n, w):
    r = sampson_residual(hat(t) @ R, x1n, x2n)
    return (w * r * r).sum(-1) / torch.clamp(w.sum(-1), min=1.0)


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def refine_rt_sampson(R0, t0, x1n, x2n, w, iters: int = 12):
    """Levenberg-damped Gauss-Newton on the essential manifold (5 dof),
    minimizing the weighted squared Sampson error of E = [t]_x R, with
    cost-decrease step acceptance. R0 (…,3,3), t0 (…,3), x*n (…,N,2),
    w (…,N). Returns (R, unit t). The Jacobian is taken by forward-mode
    AD (five ``torch.func.jvp`` passes), as the JAX package's jacfwd."""
    dtype, dev = x1n.dtype, x1n.device
    t0 = _unit(t0)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)

    def tangent_basis(t):
        ref = torch.where((t[..., 0].abs() < 0.9)[..., None], e_x, e_y)
        b1 = _unit(torch.linalg.cross(t, ref, dim=-1))
        b2 = torch.linalg.cross(t, b1, dim=-1)
        return torch.stack([b1, b2], -1)                 # (…,3,2)

    def step(delta, R, t, B):
        Rn = so3_exp(delta[..., :3]) @ R
        tn = _unit(t + (B @ delta[..., 3:, None])[..., 0])
        return Rn, tn

    batch = t0.shape[:-1]
    eye5 = torch.eye(5, dtype=dtype, device=dev)
    R, t = R0.to(dtype), t0.to(dtype)
    cost = sampson_cost(R, t, x1n, x2n, w)
    lam = torch.full(batch, 1e-4, dtype=dtype, device=dev)
    z5 = torch.zeros(batch + (5,), dtype=dtype, device=dev)
    for _ in range(iters):
        B = tangent_basis(t)

        def residual(delta):
            Rn, tn = step(delta, R, t, B)
            return sampson_residual(hat(tn) @ Rn, x1n, x2n)

        cols = []
        r = None
        for k in range(5):
            tangent = torch.zeros_like(z5)
            tangent[..., k] = 1.0
            r, jk = torch.func.jvp(residual, (z5,), (tangent,))
            cols.append(jk)
        J = torch.stack(cols, -1)                         # (…,N,5)
        Jw = J * w[..., None]
        H = J.transpose(-1, -2) @ Jw
        g = (Jw * r[..., None]).sum(-2)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        Hd = H + (lam * tr / 5.0 + 1e-12)[..., None, None] * eye5
        delta = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
        Rn, tn = step(delta, R, t, B)
        cn = sampson_cost(Rn, tn, x1n, x2n, w)
        ok = torch.isfinite(cn) & (cn <= cost)
        R = torch.where(ok[..., None, None], Rn, R)
        t = torch.where(ok[..., None], tn, t)
        cost = torch.where(ok, cn, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 10.0), 1e-8, 1e4)
    return R, t


def homography_error(H, x1, x2):
    """Symmetric transfer error^2: H (…,3,3), x (…,N,2) -> (…,N)."""
    def transfer(Hm, a, b):
        pa = torch.cat([a, torch.ones_like(a[..., :1])], -1)
        q = pa @ Hm.transpose(-1, -2)
        qz = q[..., 2:3]
        q = q[..., :2] / torch.where(qz.abs() < 1e-10,
                                     torch.full_like(qz, 1e-10), qz)
        return ((b - q) ** 2).sum(-1)

    Hinv = torch.linalg.inv_ex(H)[0]
    return transfer(H, x1, x2) + transfer(Hinv, x2, x1)
