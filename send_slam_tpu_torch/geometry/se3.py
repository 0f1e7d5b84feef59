"""SO(3)/SE(3) Lie group ops on torch tensors, batched over leading dims.

Counterpart of ``send_slam_tpu/geometry/se3.py`` with the same
conventions: rotations are (…,3,3) matrices, quaternions (x, y, z, w),
SE(3) a pair (R, t), twists ``xi = (rho, phi)`` translation first.
Small-angle branches are selected with ``torch.where`` like the
reference's ``jnp.where``, so both sides evaluate the same formulas.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """(…,3) -> (…,3,3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """(…,3,3) skew -> (…,3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    small = x.abs() < _EPS
    return torch.where(small, 1.0 - x * x / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """(…,3) axis-angle -> (…,3,3) rotation (Rodrigues)."""
    theta = torch.sqrt((phi * phi).sum(-1, keepdim=True) + 1e-24)[..., None]
    K = hat(phi)
    K2 = K @ K
    t2 = theta * theta
    small = t2 < _EPS
    one = torch.ones_like(t2)
    a = torch.where(small, 1.0 - t2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, t2))
    return _eye3(phi) + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(…,3,3) rotation -> (…,3) axis-angle, stable near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    s = _sinc(theta)[..., None]
    generic = w / torch.clamp(s, min=_EPS)
    near_pi = theta[..., None] > (math.pi - 1e-3)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis_sq = torch.clamp((diag + 1.0) * 0.5, min=1e-12)
    axis = torch.sqrt(axis_sq)
    sign_ref = torch.argmax(axis_sq, dim=-1)
    off = torch.stack([
        R[..., 0, 1] + R[..., 1, 0],
        R[..., 0, 2] + R[..., 2, 0],
        R[..., 1, 2] + R[..., 2, 1],
    ], -1)

    def signs_for(k):
        if k == 0:
            sy, sz = torch.sign(off[..., 0]), torch.sign(off[..., 1])
            return torch.stack([torch.ones_like(sy), sy, sz], -1)
        if k == 1:
            sx, sz = torch.sign(off[..., 0]), torch.sign(off[..., 2])
            return torch.stack([sx, torch.ones_like(sx), sz], -1)
        sx, sy = torch.sign(off[..., 1]), torch.sign(off[..., 2])
        return torch.stack([sx, sy, torch.ones_like(sx)], -1)

    signs = torch.where((sign_ref == 0)[..., None], signs_for(0),
                        torch.where((sign_ref == 1)[..., None], signs_for(1),
                                    signs_for(2)))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    pi_branch = axis * signs * theta[..., None]
    return torch.where(near_pi, pi_branch, generic)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta = torch.sqrt((phi * phi).sum(-1) + 1e-24)[..., None, None]
    K = hat(phi)
    K2 = K @ K
    t2 = theta * theta
    small = t2 < _EPS
    one = torch.ones_like(t2)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, t2))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, t2 * theta))
    return _eye3(phi) + b * K + c * K2


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta = torch.sqrt((phi * phi).sum(-1) + 1e-24)[..., None, None]
    K = hat(phi)
    K2 = K @ K
    t2 = theta * theta
    half = 0.5 * theta
    small = t2 < _EPS
    cot = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp(torch.sin(half), min=_EPS))
        / torch.where(small, torch.ones_like(t2), t2))
    return _eye3(phi) - 0.5 * K + cot * K2


def se3_exp(xi: torch.Tensor):
    """(…,6) twist (rho, phi) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (…,6) twist (rho, phi)."""
    phi = so3_log(R)
    Vinv = _left_jacobian_inv(phi)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_identity(dtype=torch.float32, device=None):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_apply(R, t, x):
    """Apply to points x (…,3)."""
    return (R @ x[..., None])[..., 0] + t


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """(…,3,3) -> unit quaternion (x, y, z, w), w >= 0 (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(w, x, y, z):
        return torch.stack([x, y, z, w], -1)

    q0 = mk(1 + tr, m21 - m12, m02 - m20, m10 - m01)
    q1 = mk(m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20)
    q2 = mk(m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21)
    q3 = mk(m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22)
    cs = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                      m22 - m00 - m11], -1)
    idx = torch.argmax(cs, dim=-1)[..., None]
    q = torch.where(idx == 0, q0,
                    torch.where(idx == 1, q1,
                                torch.where(idx == 2, q2, q3)))
    q = quat_normalize(q)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) -> (…,3,3)."""
    q = quat_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)
