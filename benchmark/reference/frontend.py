"""Plain NumPy front end: the pyramid, FAST-16 with 3x3 NMS, the
grid-uniform keypoint selection, the intensity-centroid angle, rotated
BRIEF and the radtan undistortion of the keypoints, worked out from the
input image alone.

It follows the engine's stated semantics (``ops/pyramid.py``,
``ops/fast.py``, ``ops/orb.py``, ``geometry/camera.py`` of the port
describe them) in float32 elementwise arithmetic in the same order, so a
sound front end gives the same keypoints, scores and descriptors bit for
bit. The moments of the angle are summed in float64 (the card sums them
in its own order), so an angle may differ in its last bits; the
comparison allows for that. Nothing here imports the port.

``precision="tf32"`` rounds each operand of the pyramid's and the blur's
multiply-adds to TF32 (10 mantissa bits), as a convolution on cuDNN with
TF32 allowed computes them: the control's front end.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np

F32 = np.float32
PATCH_R = 15
DESC_R = 16
DESC_PATCH = 2 * DESC_R + 1
N_ANGLE_BINS = 32
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
          (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
          (-2, -2), (-1, -3))
PHASE = ((0, 0.1), (1, 0.3), (2, 0.5), (3, 0.7), (4, 0.9))


def round_bits(x: np.ndarray, keep: int) -> np.ndarray:
    """Round float32 values to ``keep`` mantissa bits, to nearest even
    (keep = 7: bfloat16; keep = 10: TF32)."""
    b = np.ascontiguousarray(x, F32).view(np.uint32).astype(np.uint64)
    drop = 23 - keep
    half = (1 << (drop - 1)) - 1
    b = (b + half + ((b >> drop) & 1)) >> drop << drop
    return b.astype(np.uint32).view(F32)


def _mul(w, x, precision):
    """A float32 product w * x; in TF32 both operands rounded first."""
    if precision == "tf32":
        return F32(round_bits(np.array([w], F32), 10)[0]) * round_bits(x, 10)
    return F32(w) * x


# ---------------------------------------------------------------- pyramid

def level_shapes(h, w, n_levels):
    out = [(h, w)]
    for _ in range(1, n_levels):
        a, b = out[-1]
        out.append((max((a // 6) * 5, 5), max((b // 6) * 5, 5)))
    return out


def _down65(x, axis, precision):
    x = np.moveaxis(x, axis, 0)
    q = x.shape[0] // 6
    g = x[: q * 6].reshape((q, 6) + x.shape[1:])
    outs = [_mul(1.0 - w, g[:, o], precision) + _mul(w, g[:, o + 1], precision)
            for o, w in PHASE]
    y = np.stack(outs, 1).reshape((q * 5,) + x.shape[1:])
    return np.moveaxis(y, 0, axis)


def pyramid(img: np.ndarray, n_levels: int, precision="float32"):
    levels = [np.asarray(img, F32)]
    for _ in range(1, n_levels):
        levels.append(_down65(_down65(levels[-1], 0, precision), 1,
                              precision))
    return levels


@functools.lru_cache(maxsize=None)
def gaussian_kernel(sigma=2.0, ksize=7):
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return tuple(float(v) for v in (k / k.sum()).astype(F32))


def blur(img: np.ndarray, precision="float32") -> np.ndarray:
    """Separable 7-tap Gaussian (sigma 2), reflect-101 borders."""
    k = gaussian_kernel()
    H, W = img.shape
    x = np.pad(img, 3, mode="reflect")
    acc = None
    for i, ki in enumerate(k):
        term = _mul(ki, x[:, i:i + W], precision)
        acc = term if acc is None else acc + term
    out = None
    for i, ki in enumerate(k):
        term = _mul(ki, acc[i:i + H, :], precision)
        out = term if out is None else out + term
    return out


# ------------------------------------------------------------------- FAST

def _run9(mask):
    m = mask | (mask << 16)
    r2 = m & (m >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    return ((r8 & (m >> 8)) & 0xFFFF) != 0


def fast_score(img: np.ndarray, th: float) -> np.ndarray:
    """FAST-16 score: the largest over the 16 arcs of 9 contiguous circle
    pixels of the arc's smallest difference (bright or dark side) where
    such an arc clears ``th``, else 0."""
    H, W = img.shape
    p = np.pad(img, 3, mode="edge")
    d = np.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                  for dx, dy in CIRCLE]) - img
    wts = (1 << np.arange(16, dtype=np.int64))[:, None, None]
    bright = ((d > F32(th)) * wts).sum(0)
    dark = ((d < -F32(th)) * wts).sum(0)
    corner = _run9(bright) | _run9(dark)

    def arc9(x):
        m = np.minimum(x, np.roll(x, -1, 0))
        m2 = np.minimum(m, np.roll(m, -2, 0))
        m4 = np.minimum(m2, np.roll(m2, -4, 0))
        return np.minimum(m4, np.roll(x, -8, 0)).max(0)

    score = np.maximum(arc9(d), arc9(-d))
    return np.where(corner, score, F32(0)).astype(F32)


def nms(score: np.ndarray) -> np.ndarray:
    """3x3 maxima; a tie goes to the earlier pixel in raster order."""
    H, W = score.shape
    p = np.pad(score, 1, constant_values=-np.inf)
    keep = np.ones(score.shape, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n = p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            keep &= (score >= n) if (dy < 0 or (dy == 0 and dx < 0)) \
                else (score > n)
    return np.where(keep, score, F32(0))


# ------------------------------------------------------- keypoint choice

def _topk(x, k):
    """Top-k along the last axis, ties to the lower index."""
    idx = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(x, idx, -1), idx


def grid_topk(s_hi, s_lo, n_keep, G):
    H, W = s_hi.shape
    Hp, Wp = -(-H // G) * G, -(-W // G) * G
    ch, cw = Hp // G, Wp // G

    def cells(s):
        s = np.pad(s, ((0, Hp - H), (0, Wp - W)))
        return s.reshape(G, ch, G, cw).transpose(0, 2, 1, 3) \
            .reshape(G * G, ch * cw)

    hi, lo = cells(s_hi), cells(s_lo)
    c = np.where(hi.max(1, keepdims=True) > 0, hi, lo)
    cap = max(1, min(2 * (-(-n_keep // (G * G))), ch * cw))
    vals, idx = _topk(c, cap)
    cid = np.arange(G * G)[:, None]
    gy = (cid // G) * ch + idx // cw
    gx = (cid % G) * cw + idx % cw
    top, ti = _topk(vals.reshape(-1), n_keep)
    uv = np.stack([gx.reshape(-1)[ti], gy.reshape(-1)[ti]], -1)
    return uv, top, top > 0


# ------------------------------------------------------ angle and BRIEF

@functools.lru_cache(maxsize=None)
def brief_pattern(n_bits=256, seed=20260816):
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0.0, 31.0 / 5.0, size=(n_bits, 4)), -13, 13)
    for i in range(n_bits):
        while np.all(np.round(pts[i, :2]) == np.round(pts[i, 2:])):
            pts[i] = np.clip(rng.normal(0.0, 31.0 / 5.0, size=4), -13, 13)
    return np.round(pts).astype(np.int64)


@functools.lru_cache(maxsize=None)
def pattern_points():
    """(32 bins, 2 ends, 256, 2) rotated sample offsets (dx, dy)."""
    pat = brief_pattern().astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, 2, 256, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        for end, (px, py) in enumerate(((pat[:, 0], pat[:, 1]),
                                        (pat[:, 2], pat[:, 3]))):
            out[b, end, :, 0] = np.clip(np.round(px * ca - py * sa),
                                        -DESC_R, DESC_R)
            out[b, end, :, 1] = np.clip(np.round(px * sa + py * ca),
                                        -DESC_R, DESC_R)
    return out


@functools.lru_cache(maxsize=None)
def moment_weights():
    d = np.arange(-PATCH_R, PATCH_R + 1)
    xx, yy = np.meshgrid(d, d)
    umax = np.round(np.sqrt(np.maximum(PATCH_R ** 2 - d * d, 0)))
    mask = np.abs(xx) <= umax[:, None]
    return (xx * mask).astype(np.float64), (yy * mask).astype(np.float64)


def _centres(uv, r, H, W):
    return (np.clip(uv[:, 0], r, W - 1 - r), np.clip(uv[:, 1], r, H - 1 - r))


def angles(blurred_bf16, uv):
    H, W = blurred_bf16.shape
    x, y = _centres(uv, DESC_R, H, W)
    d = np.arange(-PATCH_R, PATCH_R + 1)
    patch = blurred_bf16[y[:, None, None] + d[None, :, None],
                         x[:, None, None] + d[None, None, :]].astype(np.float64)
    wx, wy = moment_weights()
    m0 = (patch * wx).sum((1, 2))
    m1 = (patch * wy).sum((1, 2))
    return np.arctan2(F32(m1), F32(m0)).astype(F32)


def brief(blurred_bf16, uv, angle):
    """(K, 8) uint32 words, bit j of word w = test 32 w + j."""
    H, W = blurred_bf16.shape
    x, y = _centres(uv, DESC_R, H, W)
    frac = (angle / F32(2.0 * np.pi)) * F32(N_ANGLE_BINS)
    bins = np.round(frac).astype(np.int64) % N_ANGLE_BINS
    pts = pattern_points()[bins]                       # (K, 2, 256, 2)
    vals = blurred_bf16[y[:, None, None] + pts[..., 1],
                        x[:, None, None] + pts[..., 0]]
    bits = (vals[:, 0] < vals[:, 1]).reshape(-1, 8, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def subpixel(raw, uv):
    """Separable 3-point parabola offsets on the pre-NMS map, rounded to
    bf16 as the engine's patch gather rounds them."""
    p = np.pad(raw, 1)
    s0 = raw

    def off(sm, sp):
        den = sm - F32(2.0) * s0 + sp
        with np.errstate(divide="ignore", invalid="ignore"):
            o = np.where(np.abs(den) > F32(1e-6), F32(0.5) * (sm - sp) / den,
                         F32(0))
        return round_bits(np.clip(o, F32(-0.5), F32(0.5)).astype(F32), 7)

    H, W = raw.shape
    x, y = np.clip(uv[:, 0], 0, W - 1), np.clip(uv[:, 1], 0, H - 1)
    dx = off(p[1:-1, :-2], p[1:-1, 2:])[y, x]
    dy = off(p[:-2, 1:-1], p[2:, 1:-1])[y, x]
    return np.stack([dx, dy], -1)


# ------------------------------------------------------------ the frame

def undistort(uv, cam, iters=8):
    """Fixed-point inversion of radtan (the engine's, in float32)."""
    fx, fy, cx, cy = (F32(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    k1, k2, p1, p2, k3 = (F32(cam[k]) for k in ("k1", "k2", "p1", "p2", "k3"))
    xd0 = (uv[:, 0] - cx) / fx
    yd0 = (uv[:, 1] - cy) / fy
    x, y = xd0, yd0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = F32(1.0) + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = F32(2) * p1 * x * y + p2 * (r2 + F32(2) * x * x)
        dy = p1 * (r2 + F32(2) * y * y) + F32(2) * p2 * x * y
        x, y = (xd0 - dx) / radial, (yd0 - dy) / radial
    return np.stack([fx * x + cx, fy * y + cy], -1)


def per_level_features(orb: Dict) -> List[int]:
    """The keypoint budget per level: geometric in 1 / scale, as
    ORB-SLAM3's ORBextractor sets it, the rounding drift on level 0."""
    inv = 1.0 / orb["scale_factor"]
    L, n = orb["n_levels"], orb["n_features"]
    denom = (1.0 - inv ** L) / (1.0 - inv)
    counts = [max(1, int(round(n * inv ** i / denom))) for i in range(L)]
    counts[0] += n - sum(counts)
    return counts


def frame_features(img: np.ndarray, orb: Dict, cam: Dict,
                   precision="float32") -> Dict[str, np.ndarray]:
    """The features of one (H, W) image: uv (level-0, float32), octave,
    response, angle, desc (uint32 words), valid, uv_und."""
    levels = pyramid(np.asarray(img, F32), orb["n_levels"], precision)
    budgets = per_level_features(orb)
    border = orb["edge_threshold"]
    parts = []
    for lvl, (im, n_lvl) in enumerate(zip(levels, budgets)):
        H, W = im.shape
        raw = fast_score(im, float(orb["min_th_fast"]))
        s_lo = nms(raw)
        s_hi = np.where(s_lo > F32(orb["ini_th_fast"]), s_lo, F32(0))
        ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
        inb = ((ys >= border) & (ys < H - border)
               & (xs >= border) & (xs < W - border))
        s_hi = np.where(inb, s_hi, F32(0))
        s_lo = np.where(inb, s_lo, F32(0))
        uv, resp, valid = grid_topk(s_hi, s_lo, n_lvl, orb["grid_cells"])
        bl = round_bits(blur(im, precision), 7)
        ang = angles(bl, uv)
        desc = brief(bl, uv, ang)
        uvf = uv.astype(F32)
        if orb.get("subpixel", True):
            uvf = uvf + subpixel(raw, uv)
        uv0 = (uvf + F32(0.5)) * F32(orb["scale_factor"] ** lvl) - F32(0.5)
        parts.append(dict(uv=uv0, octave=np.full(n_lvl, lvl), response=resp,
                          angle=ang, desc=desc, valid=valid))
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    dist = any(abs(cam[k]) > 0 for k in ("k1", "k2", "p1", "p2", "k3"))
    out["uv_und"] = undistort(out["uv"], cam) if dist else out["uv"]
    return out


def fast_counts(img: np.ndarray, orb: Dict):
    """What FAST with NMS has to do on the image's pyramid at min_th_fast
    (the yardstick's work count, ``harness/peaks.py``): pixels, pixels
    passing the compass pre-test, corners."""
    th = F32(orb["min_th_fast"])
    n_px = n_cand = n_corner = 0
    for im in pyramid(np.asarray(img, F32), orb["n_levels"]):
        H, W = im.shape
        p = np.pad(im, 3, mode="edge")
        c4 = np.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                       for dx, dy in (CIRCLE[j] for j in (0, 4, 8, 12))]) - im
        b, k = c4 > th, c4 < -th
        cand = ((b & np.roll(b, -1, 0)) | (k & np.roll(k, -1, 0))).any(0)
        n_px += im.size
        n_cand += int(cand.sum())
        n_corner += int((fast_score(im, float(th)) > 0).sum())
    return n_px, n_cand, n_corner
