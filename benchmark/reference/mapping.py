"""Plain NumPy mapping stages, in float64, each worked out again from the
map the engine handed its own stage:

- ``local_ba``: Levenberg-damped Gauss-Newton over a keyframe window,
  the window's keyframe poses (left increments exp(delta) T, delta =
  (rho, phi)) and the landmarks they observe; Huber-weighted residuals
  scaled by the octave's sigma^2; landmarks eliminated by their 3x3
  blocks (a Schur complement), the reduced pose system solved; a step
  kept only where the robust cost does not rise. The first keyframes of
  the window (``n_fixed``, at most all but one) and the landmarks seen
  once stay where they are. Where a step changes the cost by less than
  ``AMBIGUOUS`` of it, float32's rounding of the program's two sums
  (some 10^4 to 10^5 terms) can decide either way: the reference then
  follows both outcomes, and returns every end it reached.
- ``triangulate``: the linear two-view triangulation (the four DLT rows
  with the point's fourth coordinate 1), solved by least squares.
"""

from __future__ import annotations

import numpy as np

from reference.tracking import se3_exp

CHUNK = 2048          # landmarks per block of the Schur complement
CHI2_2DOF = 5.991
AMBIGUOUS = 1e-5      # relative cost change a float32 decision can miss
MAX_ENDS = 16


def project(R, t, X, fx, fy, cx, cy):
    """R (n,3,3), t (n,3), X (n,3) -> (u, v, p (n,3))."""
    p = np.einsum("nij,nj->ni", R, X) + t
    z = np.maximum(p[:, 2], 1e-6)
    return fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy, p


def _robust_cost(ru, rv, inv_s2, live, huber):
    chi2 = (ru * ru + rv * rv) * inv_s2
    rho = np.where(chi2 <= huber * huber, chi2,
                   2.0 * huber * np.sqrt(np.maximum(chi2, 1e-12))
                   - huber * huber)
    return float(np.where(live, rho, 0.0).sum())


def window_obs(state, ba_window, window_ids):
    """The window (gid (W,), kf_ok (W,)) and its live observations
    (keyframe slot w, keypoint n, landmark l), as the BA takes them."""
    MK = state["kf_R"].shape[0]
    ML = state["lm_pos"].shape[0]
    n_kf = int(state["n_kf"])
    if window_ids is None:
        win = max(n_kf - ba_window, 0) + np.arange(ba_window)
    else:
        win = np.asarray(window_ids, np.int64)
    gid = np.clip(win, 0, MK - 1)
    kf_ok = state["kf_valid"][gid] & (win < min(n_kf, MK))
    obs = state["kf_obs_lm"][gid].astype(np.int64)
    lm = np.clip(obs, 0, ML - 1)
    live = ((obs >= 0) & state["kf_kp_valid"][gid] & kf_ok[:, None]
            & state["lm_valid"][lm])
    w, n = np.nonzero(live)
    return gid, kf_ok, w, n, lm[w, n]


def local_ba(state, fx, fy, cx, cy, ba_window, iters, huber, damping,
             scale_factor, n_fixed, window_ids=None):
    """``state``: the map's arrays the BA reads (kf_R, kf_t, kf_uv,
    kf_octave, kf_obs_lm, kf_kp_valid, kf_valid, lm_valid, lm_pos, n_kf).
    Returns (gid (W,), kf_ok, ends): ``ends`` the (R (W,3,3), t (W,3),
    lm_pos (ML,3)) it may end at, float64."""
    gid, kf_ok, w, n, l = window_obs(state, ba_window, window_ids)
    W = gid.shape[0]
    ML = state["lm_pos"].shape[0]
    uv = state["kf_uv"][gid][w, n].astype(np.float64)
    inv_s2 = 1.0 / scale_factor ** (2.0 * state["kf_octave"][gid][w, n])
    n_anchor = min(max(int(kf_ok.sum()) - 1, 1), n_fixed)
    free = kf_ok & (np.arange(W) >= n_anchor)
    lm_free = (np.bincount(l, minlength=ML) >= 2) & state["lm_valid"]
    ulm, lpos = np.unique(l, return_inverse=True)     # the window's landmarks
    L = ulm.shape[0]

    def residuals(R, t, X):
        u, v, p = project(R[w], t[w], X[l], fx, fy, cx, cy)
        return u - uv[:, 0], v - uv[:, 1], p

    def step(R, t, X, lam):
        """One damped step: (R, t, X after it, cost before, cost after)."""
        ru, rv, p = residuals(R, t, X)
        live = p[:, 2] > 1e-3
        chi2 = (ru * ru + rv * rv) * inv_s2
        wgt = live * np.minimum(huber / np.sqrt(np.maximum(chi2, 1e-12)),
                                1.0) * inv_s2
        z = np.maximum(p[:, 2], 1e-6)
        xz, yz = p[:, 0] / z, p[:, 1] / z
        # d(u, v) / d(rho, phi) of a left increment, and / d X.
        Jp = np.zeros((len(w), 2, 6))
        Jp[:, 0, 0] = fx / z
        Jp[:, 0, 2] = -fx * xz / z
        Jp[:, 0, 3] = -fx * xz * yz
        Jp[:, 0, 4] = fx * (1.0 + xz * xz)
        Jp[:, 0, 5] = -fx * yz
        Jp[:, 1, 1] = fy / z
        Jp[:, 1, 2] = -fy * yz / z
        Jp[:, 1, 3] = -fy * (1.0 + yz * yz)
        Jp[:, 1, 4] = fy * xz * yz
        Jp[:, 1, 5] = fy * xz
        Jt = np.einsum("nka,nab->nkb", Jp[:, :, :3], R[w])
        r = np.stack([ru, rv], 1)
        H_pp = np.zeros((W, 6, 6))
        b_p = np.zeros((W, 6))
        np.add.at(H_pp, w, np.einsum("nka,n,nkb->nab", Jp, wgt, Jp))
        np.add.at(b_p, w, np.einsum("nka,n,nk->na", Jp, wgt, r))
        H_ll = np.zeros((L, 3, 3))
        b_l = np.zeros((L, 3))
        np.add.at(H_ll, lpos, np.einsum("nka,n,nkb->nab", Jt, wgt, Jt))
        np.add.at(b_l, lpos, np.einsum("nka,n,nk->na", Jt, wgt, r))
        Hpl_obs = np.einsum("nka,n,nkb->nab", Jp, wgt, Jt)      # (n,6,3)

        # Damped landmark blocks, inverted where the landmark is free.
        lam_l = lam * np.maximum(np.trace(H_ll, axis1=1, axis2=2) / 3.0,
                                 1e-6)
        Hd = H_ll + lam_l[:, None, None] * np.eye(3)
        det = np.linalg.det(Hd)
        inv_ok = lm_free[ulm] & (np.abs(det) > 1e-12)
        H_inv = np.zeros_like(Hd)
        H_inv[inv_ok] = np.linalg.inv(Hd[inv_ok])

        # The reduced pose system, a block of landmarks at a time.
        S = np.zeros((W * 6, W * 6))
        b_red = b_p.reshape(-1).copy()
        for c0 in range(0, L, CHUNK):
            c1 = min(c0 + CHUNK, L)
            sel = (lpos >= c0) & (lpos < c1)
            Hpl = np.zeros((W, c1 - c0, 6, 3))
            np.add.at(Hpl, (w[sel], lpos[sel] - c0), Hpl_obs[sel])
            A = np.einsum("wlab,lbc->walc", Hpl, H_inv[c0:c1])
            A2 = A.reshape(W * 6, -1)
            B2 = Hpl.transpose(0, 2, 1, 3).reshape(W * 6, -1)
            S -= A2 @ B2.T
            b_red -= A2 @ b_l[c0:c1].reshape(-1)
        lam_p = lam * np.maximum(np.trace(H_pp, axis1=1, axis2=2) / 6.0,
                                 1e-6)
        for k in range(W):
            S[6 * k:6 * k + 6, 6 * k:6 * k + 6] += (
                H_pp[k] + lam_p[k] * np.eye(6))
        f6 = np.repeat(free.astype(np.float64), 6)
        S = S * np.outer(f6, f6) + np.diag(1.0 - f6)
        delta_p = -np.linalg.solve(S, b_red * f6).reshape(W, 6) \
            * free[:, None]

        Hpl_dp = np.zeros((L, 3))
        np.add.at(Hpl_dp, lpos, np.einsum("nab,na->nb", Hpl_obs,
                                          delta_p[w]))
        delta_l = -np.einsum("lab,lb->la", H_inv, b_l + Hpl_dp)

        R_new, t_new = R.copy(), t.copy()
        for k in range(W):
            dR, dt = se3_exp(delta_p[k])
            R_new[k], t_new[k] = dR @ R[k], dR @ t[k] + dt
        X_new = X.copy()
        X_new[ulm] += delta_l
        ru2, rv2, p2 = residuals(R_new, t_new, X_new)
        return (R_new, t_new, X_new,
                _robust_cost(ru, rv, inv_s2, live, huber),
                _robust_cost(ru2, rv2, inv_s2, p2[:, 2] > 1e-3, huber))

    ends = [(state["kf_R"][gid].astype(np.float64),
             state["kf_t"][gid].astype(np.float64),
             state["lm_pos"].astype(np.float64))]
    for it in range(iters):
        lam = max(damping * 0.5 ** it, damping * 1e-2)
        nxt = []
        for R, t, X in ends:
            R2, t2, X2, c_old, c_new = step(R, t, X, lam)
            if c_new <= c_old + AMBIGUOUS * c_old:
                nxt.append((R2, t2, X2))
            if c_new > c_old - AMBIGUOUS * c_old:
                nxt.append((R, t, X))
        ends = nxt[:MAX_ENDS]
    return gid, kf_ok, ends


def triangulate(Ra, ta, Rb, tb, fx, fy, cx, cy, xa, xb):
    """Points (n,3) seen at pixels xa (n,2) from camera-from-world pose
    (Ra, ta) and xb from (Rb, tb), by linear least squares in float64."""
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    out = np.zeros((xa.shape[0], 3))
    Ps = [K @ np.concatenate([np.asarray(R, np.float64),
                              np.asarray(t, np.float64)[:, None]], 1)
          for R, t in ((Ra, ta), (Rb, tb))]
    for i in range(xa.shape[0]):
        rows = []
        for P, x in zip(Ps, (xa[i], xb[i])):
            rows.append(float(x[0]) * P[2] - P[0])
            rows.append(float(x[1]) * P[2] - P[1])
        A = np.array(rows)
        out[i] = np.linalg.lstsq(A[:, :3], -A[:, 3], rcond=None)[0]
    return out
