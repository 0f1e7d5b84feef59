"""Monocular two-view initialization: batched-hypothesis RANSAC.

Counterpart of ``send_slam_tpu/models/initializer.py`` ``two_view_init``:
E RANSAC (8-point on K-normalized coords, Sampson scoring) with
cheirality-first selection and a weighted refit, a parallel H RANSAC
with Faugeras decomposition, model selection by verified support, the
Sampson Gauss-Newton refinement, and the acceptance gates and quality
score. The JAX package's ``vmap`` over hypotheses and over init
references is written out as leading dims: every input may carry a
leading reference batch (B, ...), and the current frame is broadcast.

The minimal sets are a parameter (``sets``): by default they are drawn
by Gumbel-top-k from ``generator``; a test passes the JAX package's own
draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from send_slam_tpu_torch.config import TrackingConfig
from send_slam_tpu_torch.geometry.epipolar import (
    eight_point_essential, homography_dlt, homography_error,
    refine_rt_sampson, sampson_error,
)
from send_slam_tpu_torch.geometry.homography import decompose_homography
from send_slam_tpu_torch.geometry.se3 import hat
from send_slam_tpu_torch.geometry.triangulate import triangulate_batch
from send_slam_tpu_torch.ops.hamming import Matches, match_descriptors
from send_slam_tpu_torch.ops.orb import stable_topk

TOP_J = 16


class InitResult(NamedTuple):
    ok: torch.Tensor        # (…,) bool
    R: torch.Tensor         # (…,3,3) camera2-from-camera1
    t: torch.Tensor         # (…,3) median-depth-1 scale
    points: torch.Tensor    # (…,N,3) in camera 1 (= world)
    point_ok: torch.Tensor  # (…,N) bool
    matches: Matches        # A -> B matches
    n_good: torch.Tensor    # (…,) int
    score: torch.Tensor     # (…,) f32


def nanmedian(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """NaN-ignoring median with numpy/JAX semantics (mean of the two
    middle values; NaN when everything is NaN). ``torch.nanmedian``
    returns the lower middle value instead."""
    s = torch.sort(a, dim=dim).values
    n = (~torch.isnan(a)).sum(dim, keepdim=True).to(a.dtype)
    q = 0.5 * (n - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    zero = torch.zeros_like(n)
    lo = torch.maximum(torch.minimum(lo, n - 1), zero).long()
    hi = torch.maximum(torch.minimum(hi, n - 1), zero).long()
    out = torch.gather(s, dim, lo) * lw + torch.gather(s, dim, hi) * hw
    return out.squeeze(dim)


def sample_minimal_sets(generator: torch.Generator, valid: torch.Tensor,
                        n_hyp: int, k: int) -> torch.Tensor:
    """(…, n_hyp, k) distinct indices drawn uniformly from the valid
    entries of (…, N) by Gumbel-top-k. The uniforms come from
    ``generator`` on its own device and move to ``valid``'s, so a CPU
    generator gives a run on the card the draws of the same run on the
    CPU."""
    shape = valid.shape[:-1] + (n_hyp, valid.shape[-1])
    u = torch.rand(shape, generator=generator, device=generator.device) \
        .to(valid.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[..., None, :], g, torch.full_like(g, -math.inf))
    return stable_topk(g, k)[1]


def _decompose_essential(E):
    """E (…,3,3) -> R (…,4,3,3), t (…,4,3) candidates."""
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))[..., None, None]
    R2 = R2 * torch.sign(torch.linalg.det(R2))[..., None, None]
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-9)
    return torch.stack([R1, R1, R2, R2], -3), torch.stack([t, -t, t, -t], -2)


def _score_motion(R, t, K, x1, x2, valid, reproj_th2, min_parallax_cos):
    """Triangulate every match under (R, t) (…,3,3)/(…,3); x (…,N,2),
    valid (…,N), all broadcast. Returns (X, good, cos_par, err)."""
    # P in float64, as the triangulation: a float32 product rounds apart
    # on the card and the CPU, and a low-parallax point amplifies that.
    Kd = K.double()
    P1 = Kd @ torch.eye(3, 4, dtype=Kd.dtype, device=K.device)
    P2 = Kd @ torch.cat([R, t[..., None]], -1).double()
    X = triangulate_batch(P1, P2, x1, x2)
    z1 = X[..., 2]
    z2 = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]

    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)

    def reproj(P, x):
        h = Xh @ P.to(Xh.dtype).transpose(-1, -2)
        hz = h[..., 2:3]
        uv = h[..., :2] / torch.where(hz.abs() < 1e-9,
                                      torch.full_like(hz, 1e-9), hz)
        return ((uv - x) ** 2).sum(-1)

    e1 = reproj(P1, x1)
    e2 = reproj(P2, x2)
    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r1 = X
    r2 = X - C2[..., None, :]
    cos_par = (r1 * r2).sum(-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)
    finite = torch.isfinite(X).all(-1)
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (e1 < reproj_th2)
            & (e2 < reproj_th2) & (cos_par < min_parallax_cos))
    return X, good, cos_par, e1 + e2


def _pick(x, i):
    """x (B, n, …), i (B,) -> (B, …)."""
    return x[torch.arange(x.shape[0], device=x.device), i]


def two_view_init(uv_a, desc_a, valid_a, angle_a, uv_b, desc_b, valid_b,
                  angle_b, K, cfg: TrackingConfig,
                  generator: Optional[torch.Generator] = None,
                  par_scale=None,
                  sets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> InitResult:
    """Attempt monocular init between references A (world origin) and
    the current frame B. A-side inputs are (B, N, …) or unbatched;
    ``sets`` = (E sets (…, n_hyp, 8), H sets (…, n_hyp, 4))."""
    unbatched = uv_a.dim() == 2
    if unbatched:
        uv_a, desc_a, valid_a, angle_a = (x[None] for x in (
            uv_a, desc_a, valid_a, angle_a))
        if sets is not None:
            sets = tuple(s[None] for s in sets)
        if par_scale is not None:
            par_scale = torch.as_tensor(par_scale).reshape(1)
    Bn, N = uv_a.shape[0], uv_a.shape[1]
    dev = uv_a.device
    dt = uv_a.dtype

    def bcast(x, ref):
        return x if x.dim() == ref.dim() else x[None].expand((Bn,) + x.shape)

    uv_b, desc_b, valid_b, angle_b = (
        bcast(x, y) for x, y in ((uv_b, uv_a), (desc_b, desc_a),
                                 (valid_b, valid_a), (angle_b, angle_a)))

    m = match_descriptors(desc_a, desc_b, valid_a, valid_b,
                          max_dist=float(cfg.hamming_th_low), ratio=0.9,
                          mutual=True, angles_a=angle_a, angles_b=angle_b)
    x1 = uv_a
    x2 = torch.gather(uv_b, 1, torch.clamp(m.idx, 0, N - 1)[..., None]
                      .expand(-1, -1, 2))
    mvalid = m.valid

    fx, fy = K[0, 0], K[1, 1]
    Kinv = torch.linalg.inv_ex(K)[0]

    def norm_pts(x):
        return (torch.cat([x, torch.ones_like(x[..., :1])], -1)
                @ Kinv.T)[..., :2]

    x1n, x2n = norm_pts(x1), norm_pts(x2)
    th2 = 3.841 / (fx * fy)
    bidx = torch.arange(Bn, device=dev)[:, None, None]

    if sets is None:
        if generator is None:
            raise ValueError("two_view_init needs a generator or sets")
        idx_e = sample_minimal_sets(generator, mvalid, cfg.init_ransac_iters,
                                    8)
        idx_h = sample_minimal_sets(generator, mvalid, cfg.init_ransac_iters,
                                    4)
    else:
        idx_e, idx_h = (s.to(device=dev, dtype=torch.int64) for s in sets)

    # --- E RANSAC ---------------------------------------------------------
    Es = eight_point_essential(x1n[bidx, idx_e], x2n[bidx, idx_e])
    errs = sampson_error(Es, x1n[:, None], x2n[:, None])   # (B, n_hyp, N)
    inl = (errs < th2) & mvalid[:, None, :]
    scores = inl.sum(-1)
    _, top_h = stable_topk(scores, TOP_J)                    # (B, J)

    reproj_th2 = 4.0 * 3.841
    min_parallax_cos = 0.99998
    bj = torch.arange(Bn, device=dev)[:, None]
    Rs_j, ts_j = _decompose_essential(Es[bj, top_h])         # (B,J,4,…)
    _, goods_j, _, _ = _score_motion(
        Rs_j, ts_j, K, x1[:, None, None], x2[:, None, None],
        inl[bj, top_h][:, :, None, :], reproj_th2, min_parallax_cos)
    counts_j = goods_j.sum(-1)                                # (B,J,4)
    bi_flat = torch.argmax(counts_j.reshape(Bn, -1), -1)
    seed_good = _pick(goods_j.reshape(Bn, TOP_J * 4, N), bi_flat)

    E = eight_point_essential(x1n, x2n, weights=seed_good.to(dt))
    f_inl_E = (sampson_error(E, x1n, x2n) < th2) & mvalid
    Rs4, ts4 = _decompose_essential(E)                        # (B,4,…)
    Xs4, goods4, cps4, errs4 = _score_motion(
        Rs4, ts4, K, x1[:, None], x2[:, None], f_inl_E[:, None],
        reproj_th2, min_parallax_cos)
    counts4 = goods4.sum(-1)
    bi = torch.argmax(counts4, -1)
    n_good_E = _pick(counts4, bi)
    second_E = torch.sort(counts4, -1).values[:, 2]

    # --- H RANSAC ---------------------------------------------------------
    Hs = homography_dlt(x1[bidx, idx_h], x2[bidx, idx_h])
    h_errs = homography_error(Hs, x1[:, None], x2[:, None])
    h_th2 = 2.0 * 5.991
    h_inl = (h_errs < h_th2) & mvalid[:, None, :]
    h_best = torch.argmax(h_inl.sum(-1), -1)
    Hbest = homography_dlt(x1, x2, weights=_pick(h_inl, h_best).to(dt))
    h_inl_best = (homography_error(Hbest, x1, x2) < h_th2) & mvalid
    R8, t8 = decompose_homography(Hbest, K)                   # (B,8,…)
    Xs8, goods8, cps8, errs8 = _score_motion(
        R8, t8, K, x1[:, None], x2[:, None], h_inl_best[:, None],
        reproj_th2, min_parallax_cos)
    counts8 = goods8.sum(-1)
    bi_h = torch.argmax(counts8, -1)
    n_good_H = _pick(counts8, bi_h)
    second_H = torch.sort(counts8, -1).values[:, 6]

    # --- model selection ----------------------------------------------------
    use_H = n_good_H > n_good_E
    second = torch.where(use_H, second_H, second_E)
    c1, c2 = use_H[:, None, None], use_H[:, None]
    R = torch.where(c1, _pick(R8, bi_h), _pick(Rs4, bi))
    t = torch.where(c2, _pick(t8, bi_h), _pick(ts4, bi))
    point_ok = torch.where(c2, _pick(goods8, bi_h), _pick(goods4, bi))

    # --- Sampson GN refinement, re-selection, re-scoring -------------------
    w_ref = (point_ok & mvalid).to(dt)
    R, t = refine_rt_sampson(R, t, x1n, x2n, w_ref)
    f_inl = (sampson_error(hat(t) @ R, x1n, x2n) < th2) & mvalid
    X, point_ok, cos_par, sym_err = _score_motion(
        R, t, K, x1, x2, f_inl, reproj_th2, min_parallax_cos)
    n_good = point_ok.sum(-1)

    nan = torch.full_like(cos_par, math.nan)
    med_parallax = torch.arccos(torch.clamp(
        nanmedian(torch.where(point_ok, cos_par, nan)), -1.0, 1.0))
    min_par = cfg.init_min_parallax_deg * math.pi / 180.0
    if par_scale is not None:
        min_par = min_par * torch.as_tensor(par_scale, dtype=dt, device=dev)

    n_matches = mvalid.sum(-1)
    min_good_rel = cfg.init_min_good_frac * valid_a.sum(-1).to(torch.float32)
    ok = ((n_good >= cfg.init_min_matches)
          & (n_good.to(torch.float32) >= min_good_rel)
          & (n_good > 0.75 * f_inl.sum(-1))
          & (second < 0.7 * n_good)
          & (n_matches >= cfg.init_min_matches)
          & (med_parallax > min_par))

    med_depth = nanmedian(torch.where(point_ok, X[..., 2], nan))
    scale = 1.0 / torch.clamp(med_depth, min=1e-6)
    X = X * scale[:, None, None]
    t = t * scale[:, None]

    par_factor = torch.clamp(
        torch.nan_to_num(med_parallax)
        / torch.clamp(torch.as_tensor(cfg.init_par_saturation * min_par,
                                      dtype=dt, device=dev), min=1e-6),
        0.0, 1.0)
    med_err = nanmedian(torch.where(point_ok, sym_err, nan))
    err_factor = torch.clamp(1.15 - torch.nan_to_num(med_err) / (4.0 * 3.841),
                             cfg.init_err_floor, 1.0)
    score = n_good.to(torch.float32) * par_factor * err_factor
    res = InitResult(ok=ok, R=R, t=t, points=X, point_ok=point_ok, matches=m,
                     n_good=n_good, score=score)
    if unbatched:
        res = InitResult(*(Matches(*(f[0] for f in x)) if isinstance(x, Matches)
                           else x[0] for x in res))
    return res
