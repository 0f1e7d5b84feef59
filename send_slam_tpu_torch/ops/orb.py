"""ORB extraction: grid-uniform FAST keypoints, IC-angle orientation and
rotated-BRIEF 256-bit descriptors.

Counterpart of ``send_slam_tpu/ops/orb.py`` following its CPU branches:
patch gathers round pixels to bf16 and then index exactly (so the values
match the TPU's one-hot matmul bit for bit), BRIEF sampling is a row
gather. The TPU-only one-hot matmul branches are not carried over: the
card gathers natively.

Descriptors are (N, 8) int32 tensors holding the bits of the JAX
package's uint32 words (torch has no full uint32 arithmetic);
``desc.numpy().view(np.uint32)`` gives the reference layout.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

from send_slam_tpu_torch.config import OrbConfig
from send_slam_tpu_torch.ops.fast import fast_score_levels
from send_slam_tpu_torch.ops.pyramid import build_pyramid, gaussian_blur

PATCH_R = 15           # orientation patch radius (31x31)
DESC_R = 16            # descriptor gather radius (33x33)
DESC_PATCH = 2 * DESC_R + 1
N_ANGLE_BINS = 32


class FrameFeatures(NamedTuple):
    """Fixed-capacity ORB features of one frame, padded to capacity with
    ``valid`` marking the live entries."""

    uv: torch.Tensor        # (N, 2) float32 level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) float32 FAST score
    octave: torch.Tensor    # (N,) int32 pyramid level
    angle: torch.Tensor     # (N,) float32 orientation, radians
    desc: torch.Tensor      # (N, 8) int32 packed 256-bit descriptors
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """Top-k along ``dim`` with ties broken towards the lower index, as
    ``jax.lax.top_k`` does (``torch.topk`` orders ties otherwise)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


# ---------------------------------------------------------------------------
# Constant tables (numpy, same seeds and code as the JAX package)


@functools.lru_cache(maxsize=None)
def brief_pattern(n_bits: int = 256, seed: int = 20260816) -> np.ndarray:
    """(n_bits, 4) int8 Gaussian sampling pairs (x1, y1, x2, y2),
    clipped to radius 13."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 4))
    r = 13.0
    pts = np.clip(pts, -r, r)
    for i in range(n_bits):
        while np.all(np.round(pts[i, :2]) == np.round(pts[i, 2:])):
            pts[i] = np.clip(rng.normal(0.0, sigma, size=4), -r, r)
    return np.round(pts).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _ic_angle_weights(radius: int):
    d = np.arange(-radius, radius + 1)
    xx, yy = np.meshgrid(d, d)
    umax = np.round(np.sqrt(np.maximum(radius * radius - d * d, 0)))
    mask = np.abs(xx) <= umax[:, None]
    return mask, (xx * mask), (yy * mask)


@functools.lru_cache(maxsize=None)
def _ic_moment_matrix(patch_size: int) -> np.ndarray:
    """(patch_size^2, 2) f32 x/y moment weights of the centered 31x31
    circular window."""
    r = (patch_size - 1) // 2
    off = r - PATCH_R
    _, wx, wy = _ic_angle_weights(PATCH_R)
    Wx = np.zeros((patch_size, patch_size), np.float32)
    Wy = np.zeros((patch_size, patch_size), np.float32)
    Wx[off:off + 2 * PATCH_R + 1, off:off + 2 * PATCH_R + 1] = wx
    Wy[off:off + 2 * PATCH_R + 1, off:off + 2 * PATCH_R + 1] = wy
    return np.stack([Wx.reshape(-1), Wy.reshape(-1)], -1)


@functools.lru_cache(maxsize=None)
def _binned_pattern_indices() -> np.ndarray:
    """(N_ANGLE_BINS, 512) int32 flat 33x33-patch indices of the BRIEF
    sample points per quantized orientation (first endpoints, then
    second endpoints)."""
    pat = brief_pattern().astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, 512), np.int32)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        for half, (px, py) in enumerate([(pat[:, 0], pat[:, 1]),
                                         (pat[:, 2], pat[:, 3])]):
            rx = np.clip(np.round(px * ca - py * sa), -DESC_R, DESC_R)
            ry = np.clip(np.round(px * sa + py * ca), -DESC_R, DESC_R)
            out[b, half * 256:(half + 1) * 256] = \
                ((ry + DESC_R) * DESC_PATCH + (rx + DESC_R)).astype(np.int64)
    return out


_DEVICE_TABLES: dict = {}


def _table(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _DEVICE_TABLES:
        if name == "pattern":
            arr = torch.from_numpy(_binned_pattern_indices().astype(np.int64))
        else:
            arr = torch.from_numpy(_ic_moment_matrix(DESC_PATCH))
        _DEVICE_TABLES[key] = arr.to(device)
    return _DEVICE_TABLES[key]


# ---------------------------------------------------------------------------
# Keypoint selection


def _grid_topk(score: torch.Tensor, score_fallback: torch.Tensor,
               n_keep: int, grid_cells: int):
    """Spatially-uniform masked top-k: each of grid_cells^2 cells keeps
    at most ``cap`` candidates (falling back to the low-threshold map
    where the cell is empty at the high one), then a global top-k.
    Returns (uv int32 (n_keep, 2) as (x, y), score, valid)."""
    H, W = score.shape
    G = grid_cells
    Hp = -(-H // G) * G
    Wp = -(-W // G) * G
    s_hi = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H))
    s_lo = torch.nn.functional.pad(score_fallback, (0, Wp - W, 0, Hp - H))
    ch, cw = Hp // G, Wp // G

    def to_cells(s):
        return s.reshape(G, ch, G, cw).permute(0, 2, 1, 3) \
            .reshape(G * G, ch * cw)

    cells_hi = to_cells(s_hi)
    cells_lo = to_cells(s_lo)
    has_hi = cells_hi.amax(1, keepdim=True) > 0
    cells = torch.where(has_hi, cells_hi, cells_lo)

    cap = max(1, min(2 * (-(-n_keep // (G * G))), ch * cw))
    vals, idx = stable_topk(cells, cap)                 # (G*G, cap)
    cy = idx // cw
    cx = idx % cw
    cell_ids = torch.arange(G * G, device=score.device)[:, None]
    gy = (cell_ids // G) * ch + cy
    gx = (cell_ids % G) * cw + cx

    top_vals, top_i = stable_topk(vals.reshape(-1), n_keep)
    uv = torch.stack([gx.reshape(-1)[top_i], gy.reshape(-1)[top_i]],
                     -1).to(torch.int32)
    return uv, top_vals, top_vals > 0


def _subpixel_offsets(raw_score: torch.Tensor,
                      uv: torch.Tensor) -> torch.Tensor:
    """(K, 2) sub-pixel offsets in [-0.5, 0.5]: separable 3-point
    parabola fits on the pre-NMS score map, read at the keypoints."""
    p = torch.nn.functional.pad(raw_score, (1, 1, 1, 1))
    s0 = raw_score
    sxm, sxp = p[1:-1, :-2], p[1:-1, 2:]
    sym, syp = p[:-2, 1:-1], p[2:, 1:-1]

    def axis_offset(sm, s0_, sp):
        denom = sm - 2.0 * s0_ + sp
        off = torch.where(denom.abs() > 1e-6, 0.5 * (sm - sp) / denom,
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    dx = _gather_patches(axis_offset(sxm, s0, sxp), uv, 0)[:, 0, 0]
    dy = _gather_patches(axis_offset(sym, s0, syp), uv, 0)[:, 0, 0]
    return torch.stack([dx, dy], -1)


# ---------------------------------------------------------------------------
# Patch gathering, orientation, descriptors


def _gather_patches(img: torch.Tensor, uv: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """(2r+1)^2 patches at integer centers uv (K, 2) (x, y), clamped
    inside the border. Pixel values are rounded to bf16 first, then
    gathered exactly (the JAX package's CPU semantics)."""
    H, W = img.shape
    r = radius
    x = torch.clamp(uv[:, 0].long(), r, W - 1 - r)
    y = torch.clamp(uv[:, 1].long(), r, H - 1 - r)
    d = torch.arange(-r, r + 1, device=img.device)
    yy = y[:, None, None] + d[None, :, None]
    xx = x[:, None, None] + d[None, None, :]
    vals = img.to(torch.bfloat16).to(torch.float32)
    return vals[yy, xx]


def ic_angle_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle from (K, P, P) patches (centered 31x31
    circular window)."""
    K, P = patches.shape[0], patches.shape[1]
    Wm = (_table("moments", patches.device) if P == DESC_PATCH
          else torch.from_numpy(_ic_moment_matrix(P)).to(patches.device))
    m = patches.reshape(K, P * P) @ Wm
    return torch.atan2(m[:, 1], m[:, 0])


def ic_angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (radians) at integer keypoints uv
    (K, 2) of an (H, W) image."""
    return ic_angle_from_patches(_gather_patches(img, uv, PATCH_R))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words, little-endian bit order (the
    uint32 bit patterns of the JAX package's pack_bits)."""
    K = bits.shape[0]
    b = bits.reshape(K, 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    s = (b * weights).sum(-1)
    s = torch.where(s >= 2 ** 31, s - 2 ** 32, s)
    return s.to(torch.int32)


def brief_from_patches(patches: torch.Tensor,
                       angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF from (K, 33, 33) blurred patches: the orientation
    is quantized to 32 bins and the per-bin sample points gathered."""
    K = patches.shape[0]
    flat = patches.reshape(K, -1)
    two_pi = 2.0 * np.pi
    frac = (angle / two_pi) * N_ANGLE_BINS
    bins = torch.round(frac).to(torch.int64) % N_ANGLE_BINS
    idx = _table("pattern", patches.device)[bins]          # (K, 512)
    sel = torch.gather(flat, 1, idx)
    return pack_bits(sel[:, :256] < sel[:, 256:])


def brief_descriptors(blurred: torch.Tensor, uv: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF at integer keypoints uv (K, 2) of a blurred (H, W)
    image: (K, 8) int32 words."""
    return brief_from_patches(_gather_patches(blurred, uv, DESC_R), angle)


# ---------------------------------------------------------------------------
# Full extraction


def extract_orb(img: torch.Tensor, cfg: OrbConfig) -> FrameFeatures:
    """(H, W) float32 grayscale -> FrameFeatures of capacity
    cfg.n_features: ``extract_orb_batch`` of a batch of one."""
    return extract_orb_batch(img[None], cfg)[0]


def extract_orb_batch(imgs: torch.Tensor,
                      cfg: OrbConfig) -> List[FrameFeatures]:
    """(B, H, W) float32 grayscale -> one FrameFeatures per image, each
    the same bits whatever the batch. Each image's pyramid is built on
    its own; one FAST launch over every level of every image (the batch
    on the launch's second grid axis) returns each level's raw score
    map (sub-pixel fit) and its 3x3 NMS (selection)."""
    pyramids = [build_pyramid(img, cfg.n_levels, cfg.scale_factor)
                for img in imgs]
    stacked = [torch.stack([p[lvl] for p in pyramids])
               for lvl in range(cfg.n_levels)]
    scores = fast_score_levels(stacked, float(cfg.min_th_fast),
                               with_nms=True)
    return [features_from_scores(
        pyr, [(raw[b], nms[b]) for raw, nms in scores], cfg)
        for b, pyr in enumerate(pyramids)]


def features_from_scores(levels: List[torch.Tensor], scores,
                         cfg: OrbConfig) -> FrameFeatures:
    """The rest of extract_orb_batch after FAST, for one image: per
    level, the threshold and border masks, the grid top-k on the NMS
    map, the blurred patches, the IC angle, rotated BRIEF and the
    sub-pixel fit on the raw map.
    ``scores`` holds a (raw, nms) pair per level."""
    budgets = cfg.per_level_features
    border = cfg.edge_threshold
    dev = levels[0].device
    parts: List[FrameFeatures] = []
    for lvl, (level_img, n_lvl) in enumerate(zip(levels, budgets)):
        H, W = level_img.shape
        raw, s_lo = scores[lvl]
        zero = torch.zeros_like(s_lo)
        s_hi = torch.where(s_lo > float(cfg.ini_th_fast), s_lo, zero)
        ys = torch.arange(H, device=dev)[:, None]
        xs = torch.arange(W, device=dev)[None, :]
        inb = ((ys >= border) & (ys < H - border)
               & (xs >= border) & (xs < W - border))
        s_hi = torch.where(inb, s_hi, zero)
        s_lo = torch.where(inb, s_lo, zero)

        uv_l, resp, valid = _grid_topk(s_hi, s_lo, n_lvl, cfg.grid_cells)
        blurred = gaussian_blur(level_img, sigma=2.0, ksize=7)
        patches = _gather_patches(blurred, uv_l, DESC_R)
        angle = ic_angle_from_patches(patches)
        desc = brief_from_patches(patches, angle)

        scale = cfg.scale_factor ** lvl
        uvf = uv_l.to(torch.float32)
        if cfg.subpixel:
            uvf = uvf + _subpixel_offsets(raw, uv_l)
        uv0 = (uvf + 0.5) * scale - 0.5
        parts.append(FrameFeatures(
            uv=uv0, response=resp,
            octave=torch.full((n_lvl,), lvl, dtype=torch.int32, device=dev),
            angle=angle, desc=desc, valid=valid))

    return FrameFeatures(*(torch.cat([getattr(p, f) for p in parts])
                           for f in FrameFeatures._fields))
