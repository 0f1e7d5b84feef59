"""Plain NumPy tracking stages: the descriptor matcher and the robust
pose-only Gauss-Newton, each worked out again from the inputs the engine
gave its own stage.

- ``match``: Hamming distances of 256-bit descriptors by popcount of
  their XOR, the best column of each row (a tie to the lower index), the
  distance and ratio tests and the mutual check. Exact: a sound matcher
  gives the same pairs.
- ``pose_gn``: ``rounds`` x ``iters`` Huber-weighted Gauss-Newton steps on
  the pose (a left increment exp(delta) T, delta = (rho, phi)) with the
  chi2 inlier reclassification after each round, in float64.
"""

from __future__ import annotations

import numpy as np

INVALID = 1e9
CHI2_2DOF = 5.991


def _popcount(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    return np.unpackbits(x.view(np.uint8), axis=-1).reshape(
        x.shape + (32,)).sum(-1)


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 8), (m, 8) uint32 words -> (n, m) distances."""
    out = np.zeros((a.shape[0], b.shape[0]), np.int64)
    for w in range(a.shape[1]):
        out += _popcount(np.bitwise_xor(a[:, w, None], b[None, :, w]))
    return out


def match(desc_a, desc_b, valid_a, valid_b, max_dist, ratio, mutual,
          extra_mask=None):
    """Row view (idx (n,) int64, -1 where unmatched; dist; valid) and the
    column view (idx (m,), valid) of the mutual 1-1 set. Distances are
    taken only where the masks allow a pair, on the rows and columns that
    have one."""
    n, m = desc_a.shape[0], desc_b.shape[0]
    allow = valid_a[:, None] & valid_b[None, :]
    if extra_mask is not None:
        allow &= extra_mask
    rows = np.flatnonzero(allow.any(1))
    cols = np.flatnonzero(allow.any(0))
    d = np.full((rows.size, cols.size), INVALID)
    sub = allow[np.ix_(rows, cols)]
    if rows.size and cols.size:
        d = np.where(sub, hamming(desc_a[rows], desc_b[cols]), INVALID)
    best_idx = np.full(n, -1)
    best = np.full(n, INVALID)
    ok = np.zeros(n, bool)
    back = np.full(m, -1)
    if rows.size and cols.size:
        j = np.argmin(d, 1)
        best[rows] = d[np.arange(rows.size), j]
        best_idx[rows] = cols[j]
        if ratio < 1e6:
            d2 = d.copy()
            d2[np.arange(rows.size), j] = INVALID
            second = d2.min(1)
            # The ratio test in float32, as the engine takes it.
            ok[rows] = (best[rows] <= max_dist) & (
                best[rows].astype(np.float32)
                < np.float32(ratio) * second.astype(np.float32))
        else:
            ok[rows] = best[rows] <= max_dist
        back[cols] = rows[np.argmin(d, 0)]
        if mutual:
            matched = ok & (best_idx >= 0)
            ok[matched] &= back[best_idx[matched]] == np.flatnonzero(matched)
    idx = np.where(ok, best_idx, -1)
    col_ok = np.zeros(m, bool)
    has = back >= 0
    col_ok[has] = ok[back[has]] & (best_idx[back[has]] == np.flatnonzero(has))
    return (idx, np.where(ok, best, INVALID), ok,
            np.where(col_ok, back, -1), col_ok)


# ----------------------------------------------------------------- pose

def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def se3_exp(xi):
    rho, phi = xi[:3], xi[3:]
    th = np.linalg.norm(phi)
    K = _hat(phi)
    if th < 1e-8:
        R = np.eye(3) + K + 0.5 * K @ K
        V = np.eye(3) + 0.5 * K + K @ K / 6.0
    else:
        R = (np.eye(3) + np.sin(th) / th * K
             + (1 - np.cos(th)) / th ** 2 * K @ K)
        V = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * K
             + (th - np.sin(th)) / th ** 3 * K @ K)
    return R, V @ rho


def _project(R, t, X, fx, fy, cx, cy):
    p = X @ R.T + t
    z = np.maximum(p[:, 2], 1e-6)
    uv = np.stack([fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy], -1)
    return uv, p, z


def _jacobian(p, z, fx, fy):
    """(N, 2, 6) d uv / d (rho, phi) of a left increment."""
    iz = 1.0 / z
    x, y, zz = p[:, 0], p[:, 1], p[:, 2]
    J = np.zeros((p.shape[0], 2, 6))
    J[:, 0, 0] = fx * iz
    J[:, 0, 2] = -fx * x * iz * iz
    J[:, 1, 1] = fy * iz
    J[:, 1, 2] = -fy * y * iz * iz
    # d p / d phi = -hat(p)
    Jp = J[:, :, :3].copy()
    neg_hat = np.zeros((p.shape[0], 3, 3))
    neg_hat[:, 0, 1], neg_hat[:, 0, 2] = zz, -y
    neg_hat[:, 1, 0], neg_hat[:, 1, 2] = -zz, x
    neg_hat[:, 2, 0], neg_hat[:, 2, 1] = y, -x
    J[:, :, 3:] = Jp @ neg_hat
    return J


def pose_gn(R0, t0, X, uv_obs, w_valid, fx, fy, cx, cy, sigma2, rounds,
            iters, huber_delta):
    """The robust pose-only Gauss-Newton in float64. Returns (R, t,
    inlier)."""
    R, t = np.asarray(R0, np.float64), np.asarray(t0, np.float64)
    X = np.asarray(X, np.float64)
    uv_obs = np.asarray(uv_obs, np.float64)
    inv_s2 = 1.0 / np.asarray(sigma2, np.float64)
    inlier = w_valid.copy()
    for _ in range(rounds):
        for _ in range(iters):
            uv, p, z = _project(R, t, X, fx, fy, cx, cy)
            J = _jacobian(p, z, fx, fy)
            r = uv - uv_obs
            chi2 = (r * r).sum(-1) * inv_s2
            w_h = np.minimum(huber_delta / np.sqrt(np.maximum(chi2, 1e-12)),
                             1.0)
            w = (w_valid & inlier & (p[:, 2] > 1e-3)) * w_h * inv_s2
            H = np.einsum("nia,n,nib->ab", J, w, J) + 1e-6 * np.eye(6)
            b = np.einsum("nia,n,ni->a", J, w, r)
            dR, dt = se3_exp(-np.linalg.solve(H, b))
            R, t = dR @ R, dR @ t + dt
        uv, p, _ = _project(R, t, X, fx, fy, cx, cy)
        chi2 = ((uv - uv_obs) ** 2).sum(-1) * inv_s2
        inlier = w_valid & (chi2 < CHI2_2DOF) & (p[:, 2] > 1e-3)
    return R, t, inlier


def reprojection_gap(Ra, ta, Rb, tb, X, mask, fx, fy, cx, cy):
    """RMS pixel distance between the projections of X[mask] under two
    poses (None when the mask is empty)."""
    if not mask.any():
        return None
    ua, _, _ = _project(Ra, ta, X[mask], fx, fy, cx, cy)
    ub, _, _ = _project(Rb, tb, X[mask], fx, fy, cx, cy)
    return float(np.sqrt(((ua - ub) ** 2).sum(-1).mean()))
