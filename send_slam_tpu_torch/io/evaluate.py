"""Trajectory evaluation: Sim(3) Umeyama alignment + ATE RMSE (numpy).

A copy of the JAX package's ``send_slam_tpu/io/evaluate.py`` (pure
numpy), kept here so the port scores trajectories without importing
that package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform: dst ~ s * R @ src + t.

    src, dst: (N, 3). Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (TUM tools style). Returns index
    arrays (into a and b) of matched pairs."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(ts_a):
        while j + 1 < len(ts_b) and abs(ts_b[j + 1] - ta) <= abs(ts_b[j] - ta):
            j += 1
        if abs(ts_b[j] - ta) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def ate_rmse(est_ts, est_pos, gt_ts, gt_pos, max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE after Sim(3) alignment."""
    est_ts = np.asarray(est_ts, float)
    gt_ts = np.asarray(gt_ts, float)
    est_pos = np.asarray(est_pos, float)
    gt_pos = np.asarray(gt_pos, float)
    ia, ib = associate(est_ts, gt_ts, max_dt)
    if len(ia) < 3:
        return float("inf")
    e = est_pos[ia]
    g = gt_pos[ib]
    s, R, t = umeyama_alignment(e, g, with_scale=True)
    aligned = (s * (R @ e.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - g) ** 2, -1))))
