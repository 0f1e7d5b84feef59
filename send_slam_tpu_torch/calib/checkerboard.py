"""Checkerboard corner detection for camera calibration.

The port's counterpart of ``send_slam_tpu/calib/checkerboard.py``, line
for line: the ChESS ring response, 3x3 NMS with the top-k and the
cornerSubPix-style Newton refinement run on the device as dense tensor
math; the lattice ordering (``_order_into_grid``) is the same host-side
numpy graph walk over fewer than 100 points, copied here because the
port imports nothing of the JAX package.

Corners come back in the row-major order the reference (and OpenCV)
uses, row by row along the board's columns axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.ops.pyramid import gaussian_blur

# Ring of 16 samples, radius 5 (ChESS standard).
_RING = [(5, 0), (5, 2), (4, 4), (2, 5), (0, 5), (-2, 5), (-4, 4), (-5, 2),
         (-5, 0), (-5, -2), (-4, -4), (-2, -5), (0, -5), (2, -5), (4, -4),
         (5, -2)]


def corner_response_map(img: torch.Tensor) -> torch.Tensor:
    """Dense ChESS response. img: (H, W) float. High at X-junctions."""
    H, W = img.shape
    p = F.pad(img[None, None], (5, 5, 5, 5), mode="replicate")[0, 0]
    s = torch.stack([p[5 + dy: 5 + dy + H, 5 + dx: 5 + dx + W]
                     for dx, dy in _RING])              # (16, H, W)
    # Sum response: quarter-turn difference high, half-turn low.
    sr = torch.sum(torch.abs(s - torch.roll(s, 4, 0)), 0) \
        - torch.sum(torch.abs(s - torch.roll(s, 8, 0)), 0)
    # Penalize plain edges: local mean vs center.
    mr = torch.abs(torch.mean(s, 0) - img)
    return sr - 2.0 * mr


def _nms_topk(resp: torch.Tensor, k: int, border: int = 8):
    """3x3 NMS + top-k -> (uv (k,2) float, score (k,)). Ties are ordered
    as ``jax.lax.top_k`` orders them, by the lower flat index: a stable
    sort of the negated scores (``torch.topk`` promises no order among
    equal values on the card, and blurred boards have plateaus)."""
    H, W = resp.shape
    p = F.pad(resp, (1, 1, 1, 1), mode="constant", value=-float("inf"))
    keep = torch.ones_like(resp, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            keep &= resp >= p[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
    ys = torch.arange(H, device=resp.device)[:, None]
    xs = torch.arange(W, device=resp.device)[None, :]
    inb = ((ys >= border) & (ys < H - border)
           & (xs >= border) & (xs < W - border))
    r = torch.where(keep & inb, resp, torch.full_like(resp, -float("inf")))
    neg, idx = torch.sort(-r.reshape(-1), stable=True)
    vals, idx = -neg[:k], idx[:k]
    uv = torch.stack([(idx % W).to(torch.float32),
                      (idx // W).to(torch.float32)], -1)
    return uv, vals


def refine_subpixel(img: torch.Tensor, uv: torch.Tensor, win: int = 5,
                    iters: int = 10) -> torch.Tensor:
    """cornerSubPix-style refinement: at a saddle/corner point q, every
    window pixel p satisfies grad(p) . (p - q) = 0; solve the weighted
    normal equations iteratively. uv: (K,2) float, of img's dtype."""
    gy, gx = torch.gradient(img)
    dev, dt = img.device, img.dtype
    d = torch.arange(-win, win + 1, device=dev)
    wx = torch.exp(-(d.to(dt) ** 2) / (2.0 * (win / 2.0) ** 2))
    wmask = wx[:, None] * wx[None, :]                  # Gaussian window

    H, W = img.shape

    def gather(a, x0, y0):
        xs = torch.clamp(x0[:, None, None] + d[None, None, :], 0, W - 1)
        ys = torch.clamp(y0[:, None, None] + d[None, :, None], 0, H - 1)
        return a[ys, xs]                               # (K, 2w+1, 2w+1)

    for _ in range(iters):
        x0 = torch.round(uv[:, 0]).to(torch.int64)
        y0 = torch.round(uv[:, 1]).to(torch.int64)
        Gx = gather(gx, x0, y0)
        Gy = gather(gy, x0, y0)
        zero = torch.zeros_like(Gx)
        px = (x0[:, None, None] + d[None, None, :]).to(dt) + zero
        py = (y0[:, None, None] + d[None, :, None]).to(dt) + zero
        w = wmask[None]
        a = torch.sum(w * Gx * Gx, (1, 2))
        b = torch.sum(w * Gx * Gy, (1, 2))
        c = torch.sum(w * Gy * Gy, (1, 2))
        bx = torch.sum(w * (Gx * Gx * px + Gx * Gy * py), (1, 2))
        by = torch.sum(w * (Gx * Gy * px + Gy * Gy * py), (1, 2))
        det = a * c - b * b
        det = torch.where(torch.abs(det) < 1e-9,
                          torch.full_like(det, 1e-9), det)
        qx = (c * bx - b * by) / det
        qy = (a * by - b * bx) / det
        new = torch.stack([qx, qy], -1)
        # Clamp per-step movement (stability on weak corners).
        uv = uv + torch.clamp(new - uv, -2.0, 2.0)
    return uv


# ---------------------------------------------------------------------------
# Host-side lattice ordering (the JAX package's numpy, unchanged)


def _order_into_grid(pts: np.ndarray, pattern: Tuple[int, int],
                     scores: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Assign candidate corners to a (cols, rows) checkerboard lattice.

    Greedy lattice walk: estimate the two dominant neighbour directions,
    then BFS from a seed assigning integer (i, j) coordinates. Board-
    edge junctions land on the lattice one step outside the true inner
    grid, so the final step slides a (cols x rows) window over the
    occupied lattice and keeps the fully-occupied placement with the
    highest total corner response. Returns (rows*cols, 2) corners in
    row-major order, or None."""
    cols, rows = pattern
    need = cols * rows
    n = len(pts)
    if n < need:
        return None
    if scores is None:
        scores = np.ones(n)

    # Neighbour graph: for each point its nearest few neighbours.
    d2 = np.sum((pts[:, None] - pts[None, :]) ** 2, -1)
    np.fill_diagonal(d2, np.inf)
    nn_dist = np.sqrt(np.partition(d2, 0, axis=1)[:, 0])
    med = np.median(nn_dist)
    if not np.isfinite(med) or med <= 1e-6:
        return None

    # Dominant lattice directions from neighbour displacement angles.
    nbr_idx = np.argsort(d2, axis=1)[:, :4]
    disp = (pts[nbr_idx] - pts[:, None]).reshape(-1, 2)
    keep = (np.linalg.norm(disp, axis=1) < 1.6 * med)
    disp = disp[keep]
    if len(disp) < 8:
        return None
    ang = np.mod(np.arctan2(disp[:, 1], disp[:, 0]), np.pi)
    hist, edges = np.histogram(ang, bins=36, range=(0, np.pi))
    # Two dominant, roughly orthogonal directions.
    a1 = edges[np.argmax(hist)] + np.pi / 72
    rel = np.mod(ang - a1 + np.pi / 2, np.pi) - np.pi / 2
    mask2 = np.abs(rel) > np.pi / 5
    if not mask2.any():
        return None
    hist2, _ = np.histogram(np.mod(ang[mask2], np.pi), bins=36, range=(0, np.pi))
    a2 = edges[np.argmax(hist2)] + np.pi / 72

    def dir_vec(a):
        v = np.array([np.cos(a), np.sin(a)])
        ds = disp[np.abs(np.mod(ang - a + np.pi / 2, np.pi) - np.pi / 2) < np.pi / 8]
        if len(ds):
            lens = np.linalg.norm(ds, axis=1)
            return v * np.median(lens)
        return v * med

    v1, v2 = dir_vec(a1), dir_vec(a2)

    # BFS from the centroid-nearest point assigning lattice coords.
    seed = int(np.argmin(np.sum((pts - pts.mean(0)) ** 2, -1)))
    coords = {seed: (0, 0)}
    frontier = [seed]
    used = {seed}
    while frontier:
        cur = frontier.pop()
        ci, cj = coords[cur]
        for (di, dj, v) in ((1, 0, v1), (-1, 0, -v1), (0, 1, v2), (0, -1, -v2)):
            target = pts[cur] + v
            cand = int(np.argmin(np.sum((pts - target) ** 2, -1)))
            if cand in used:
                continue
            if np.linalg.norm(pts[cand] - target) < 0.35 * med:
                coords[cand] = (ci + di, cj + dj)
                used.add(cand)
                frontier.append(cand)

    if len(coords) < need:
        return None
    ij = np.array(list(coords.values()))
    ids = np.array(list(coords.keys()))
    imin, jmin = ij.min(0)
    ij = ij - (imin, jmin)
    ispan, jspan = ij.max(0) + 1

    # Occupancy/score/position lattice (may be larger than the pattern
    # if edge junctions were picked up).
    grid = np.full((jspan, ispan, 2), np.nan)
    sgrid = np.full((jspan, ispan), -np.inf)
    for (i, j), pid in zip(ij, ids):
        grid[j, i] = pts[pid]
        sgrid[j, i] = scores[pid]

    def best_window(g, s, wc, wr):
        """Best fully-occupied (wr x wc) window by total score."""
        best, best_val = None, -np.inf
        for j0 in range(g.shape[0] - wr + 1):
            for i0 in range(g.shape[1] - wc + 1):
                sub = g[j0:j0 + wr, i0:i0 + wc]
                if np.isnan(sub).any():
                    continue
                val = s[j0:j0 + wr, i0:i0 + wc].sum()
                if val > best_val:
                    best, best_val = sub, val
        return best

    cand = None
    if ispan >= cols and jspan >= rows:
        cand = best_window(grid, sgrid, cols, rows)
    if cand is None and ispan >= rows and jspan >= cols:
        sub = best_window(grid, sgrid, rows, cols)
        if sub is not None:
            cand = sub.transpose(1, 0, 2)
    if cand is None:
        return None
    grid = cand

    # Canonical order: row-major, first corner top-left-most.
    if grid[0, 0, 1] + grid[0, 0, 0] > grid[-1, -1, 1] + grid[-1, -1, 0]:
        grid = grid[::-1, ::-1]
    return grid.reshape(-1, 2)


def detect_checkerboard(img: np.ndarray, pattern: Tuple[int, int] = (9, 6),
                        device=None) -> Optional[np.ndarray]:
    """Detect an inner-corner checkerboard lattice on ``device`` (default
    the card).

    img: (H, W) grayscale (uint8 or float). pattern: (cols, rows) inner
    corners, default {9, 6} like the reference (camera_calibrator.ex).
    Returns (cols*rows, 2) float32 sub-pixel corners in row-major order,
    or None if not found."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    x = gaussian_blur(x, 1.5, 5)
    resp = corner_response_map(x)
    k = int(pattern[0] * pattern[1] * 1.5)
    uv, score = _nms_topk(resp, k)
    uv_np = uv.cpu().numpy()
    score_np = score.cpu().numpy()
    # Keep clear detections only (response well above the noise floor).
    th = max(float(np.max(score_np)) * 0.2, 1e-3)
    keep = score_np > th
    cand = uv_np[keep]
    if len(cand) < pattern[0] * pattern[1]:
        return None
    ordered = _order_into_grid(cand, pattern, score_np[keep])
    if ordered is None:
        return None
    refined = refine_subpixel(
        x, torch.as_tensor(np.asarray(ordered, np.float32), device=dev))
    return refined.cpu().numpy().astype(np.float32)
