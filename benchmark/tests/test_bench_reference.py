"""The plain reference against the program at a small size on the CPU:
each stage it works out again gives what the program's stage gives, and
a whole run of each cell comes out correct."""

import numpy as np
import pytest
import torch

from bench_helpers import check, run_small, small_cell
from harness.traffic import generate
from reference import frontend as rf
from reference import mapping as rm
from reference import tracking as rt

from send_slam_tpu_torch.config import MapConfig
from send_slam_tpu_torch.geometry.se3 import so3_exp
from send_slam_tpu_torch.geometry.triangulate import triangulate_batch
from send_slam_tpu_torch.models.frame import make_frame
from send_slam_tpu_torch.models.local_ba import local_bundle_adjustment
from send_slam_tpu_torch.models.map_state import empty_map
from send_slam_tpu_torch.models.tracking import pose_only_gn
from send_slam_tpu_torch.ops.hamming import match_descriptors

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0)
FRONTEND = check("frontend_mismatch_pct")
MATCH = check("match_mismatch_pct")
POSE = check("pose_gap_px")
BA = check("ba_gap_px")


def _engine(cell):
    import run
    return run.engine_config(cell.config["engine"])


def test_frontend_equals_the_program():
    cell = small_cell("tum_fr1.steady", width=320, height=240, features=400,
                      levels=4, lap=30)
    tr = generate(cell.traffic, cell.config)
    cfg = _engine(cell)
    items = [(tr.frames[k], make_frame(tr.frames[k], 0.0, cfg.orb,
                                          cfg.camera, device="cpu"))
             for k in (0, 17)]
    eng = cell.config["engine"]
    assert FRONTEND.mismatch_pct(items, eng["orb"], eng["camera"]) == 0.0
    # One altered descriptor word is seen.
    img, f = items[0]
    desc = f.feat.desc.clone()
    desc[3, 2] ^= 1
    bad = f._replace(feat=f.feat._replace(desc=desc))
    assert FRONTEND.mismatch_pct([(img, bad)], eng["orb"],
                                 eng["camera"]) > 0


def test_tf32_front_end_is_far_off():
    cell = small_cell("tum_fr1.steady", width=640, height=480,
                      features=1000, levels=8, lap=30)
    tr = generate(cell.traffic, cell.config)
    eng = cell.config["engine"]
    a = rf.frame_features(tr.frames[5], eng["orb"], eng["camera"])
    b = rf.frame_features(tr.frames[5], eng["orb"], eng["camera"], "tf32")
    differs = ((np.abs(a["uv"] - b["uv"]).max(1) > 1e-4)
               | (a["desc"] != b["desc"]).any(1))
    assert differs[a["valid"]].mean() > 0.05


def _random_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("ratio,mutual,masked", [(1e9, True, True),
                                                 (0.8, True, False),
                                                 (0.9, False, True)])
def test_matcher_equals_the_program(ratio, mutual, masked):
    rng = np.random.default_rng(4)
    a = _random_desc(rng, 300)
    b = _random_desc(rng, 200)
    # Near copies and exact duplicates make ties and close seconds.
    b[:80] = a[:80] ^ (1 << rng.integers(0, 32, (80, 8))).astype(np.uint32)
    b[80:90] = b[70:80]
    va, vb = rng.random(300) < 0.9, rng.random(200) < 0.9
    mask = rng.random((300, 200)) < 0.3 if masked else None
    t = (lambda x: torch.from_numpy(x.view(np.int32).copy()))  # noqa: E731
    out = match_descriptors(t(a), t(b), torch.from_numpy(va),
                            torch.from_numpy(vb), max_dist=110.0,
                            ratio=ratio, mutual=mutual,
                            extra_mask=None if mask is None
                            else torch.from_numpy(mask),
                            return_col=mutual)
    row, col = out if mutual else (out, None)
    idx, _, ok, cidx, cok = rt.match(a, b, va, vb, 110.0, ratio, mutual, mask)
    assert ok.sum() > 10
    assert np.array_equal(row.valid.numpy(), ok)
    assert np.array_equal(row.idx.numpy(), idx)
    if col is not None:
        assert np.array_equal(col.valid.numpy(), cok)
        assert np.array_equal(col.idx.numpy(), cidx)
    kw = dict(max_dist=110.0, ratio=ratio, mutual=mutual,
              extra_mask=None if mask is None else torch.from_numpy(mask),
              return_col=mutual)
    args = (t(a), t(b), torch.from_numpy(va), torch.from_numpy(vb))
    assert MATCH.mismatch_pct([(args, kw, out)]) == 0.0


def test_pose_gn_equals_the_program():
    from send_slam_tpu_torch.geometry.se3 import so3_exp
    rng = np.random.default_rng(7)
    n = 300
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (n, 3))
    R_true = so3_exp(torch.tensor([0.02, -0.05, 0.01])).double().numpy()
    t_true = np.array([0.1, -0.05, 0.2])
    p = X @ R_true.T + t_true
    uv = np.stack([500 * p[:, 0] / p[:, 2] + 320,
                   500 * p[:, 1] / p[:, 2] + 240], -1)
    uv += rng.normal(0, 0.7, uv.shape)
    uv[:30] += rng.normal(0, 40, (30, 2))        # outliers
    octave = rng.integers(0, 4, n)
    sigma2 = (1.2 ** octave) ** 2
    valid = rng.random(n) < 0.95
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    args = (f32(np.eye(3)), f32(np.zeros(3)), f32(X), f32(uv),
            torch.from_numpy(valid), 500.0, 500.0, 320.0, 240.0)
    kw = dict(sigma2=f32(sigma2), huber_delta=2.447, iters=5, rounds=4)
    out = pose_only_gn(*args, **kw)
    cam = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    gap = POSE.gap_px([(args, kw, out)], cam)
    assert gap < 1e-3
    # A pose returned as it came in is far off, and the largest gap of
    # several calls is judged.
    stuck = out._replace(R=args[0], t=args[1])
    assert POSE.gap_px([(args, kw, stuck)], cam) > 1.0
    assert POSE.gap_px([(args, kw, out)] * 5 + [(args, kw, stuck)],
                       cam) > 1.0


def _ba_map(seed=3, MK=8, ML=512, N=200, n_kf=6, n_pts=300):
    """A map of ``n_kf`` keyframes seeing ``n_pts`` points, its poses and
    landmarks perturbed, a few observations far off."""
    rng = np.random.default_rng(seed)
    cfg = MapConfig(max_keyframes=MK, max_landmarks=ML, ba_window=6)
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    X = rng.uniform([-3, -2, 4], [3, 2, 9], (n_pts, 3))
    kR = np.tile(np.eye(3, dtype=np.float32), (MK, 1, 1))
    kt = np.zeros((MK, 3), np.float32)
    uv = np.zeros((MK, N, 2), np.float32)
    obs = -np.ones((MK, N), np.int32)
    kp_ok = np.zeros((MK, N), bool)
    for k in range(n_kf):
        R = so3_exp(torch.tensor(rng.normal(0, 0.02, 3))).double().numpy()
        t = -R @ np.array([0.15 * k, 0.02 * k, 0.0])
        ids = rng.choice(n_pts, N, replace=False)
        p = X[ids] @ R.T + t
        uv[k] = np.stack([fx * p[:, 0] / p[:, 2] + cx,
                          fy * p[:, 1] / p[:, 2] + cy], -1) \
            + rng.normal(0, 0.5, (N, 2))
        uv[k, :10] += rng.normal(0, 20, (10, 2))
        obs[k], kp_ok[k] = ids, True
        dR = so3_exp(torch.tensor(rng.normal(0, 0.003, 3))).double().numpy()
        kR[k], kt[k] = dR @ R, t + rng.normal(0, 0.01, 3)
    lm = np.zeros((ML, 3), np.float32)
    lm[:n_pts] = X + rng.normal(0, 0.03, X.shape)
    T = torch.from_numpy
    m = empty_map(cfg, N, device="cpu").replace(
        kf_R=T(kR), kf_t=T(kt), kf_uv=T(uv), kf_obs_lm=T(obs),
        kf_kp_valid=T(kp_ok),
        kf_octave=T(rng.integers(0, 3, (MK, N)).astype(np.int32)),
        kf_valid=T(np.arange(MK) < n_kf), lm_pos=T(lm),
        lm_valid=T(np.arange(ML) < n_pts),
        n_kf=torch.tensor(n_kf, dtype=torch.int32))
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                     dtype=torch.float32)
    return m, K, cfg


@pytest.mark.parametrize("kw", [
    dict(iters=4), dict(iters=1, damping=torch.tensor(2.5e-4), prune=False),
    dict(iters=10, n_fixed=1),
    dict(iters=3, window_ids=torch.tensor([0, 2, 3, 5, 7],
                                          dtype=torch.int32))],
    ids=["insertion", "slice", "bootstrap", "window"])
def test_local_ba_equals_the_program(kw):
    m, K, cfg = _ba_map()
    out = local_bundle_adjustment(m, K, cfg, **kw)
    gap = BA.gap_px([BA.keep_all((m, K, cfg), kw, out)], CAM, 1.2)
    assert gap < 1e-4
    # A map returned as it came in is far off.
    stuck = BA.gap_px([BA.keep_all((m, K, cfg), kw, m)], CAM, 1.2)
    assert stuck > 1.0


def test_triangulation_equals_the_program():
    rng = np.random.default_rng(5)
    X = rng.uniform([-2, -2, 3], [2, 2, 8], (200, 3))
    Ra = np.eye(3)
    ta = np.zeros(3)
    Rb = so3_exp(torch.tensor([0.01, -0.03, 0.0])).double().numpy()
    tb = -Rb @ np.array([0.12, 0.01, 0.02])
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))

    def pix(R, t):
        p = X @ R.T + t
        return (np.stack([fx * p[:, 0] / p[:, 2] + cx,
                          fy * p[:, 1] / p[:, 2] + cy], -1)
                + rng.normal(0, 0.4, (len(X), 2))).astype(np.float32)

    xa, xb = pix(Ra, ta), pix(Rb, tb)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    P = [torch.from_numpy(K @ np.concatenate([R, t[:, None]], 1))
         for R, t in ((Ra, ta), (Rb, tb))]
    got = triangulate_batch(P[0], P[1], torch.from_numpy(xa),
                            torch.from_numpy(xb)).numpy()
    ref = rm.triangulate(Ra, ta, Rb, tb, fx, fy, cx, cy, xa, xb)
    rel = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert rel.max() < 1e-6
    assert np.abs(ref - X).max() > 1e-3          # the pixels were noisy


def test_round_bits():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 255.4, -3.3e-3],
                 np.float32)
    y = rf.round_bits(x, 7)
    ref = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(y, ref)


def test_a_whole_run_is_correct():
    res, lines = run_small(small_cell("tum_fr1.steady"), seconds=30.0)
    checks = res["checks"]
    assert res["correct"], lines
    assert checks["frontend_mismatch_pct"]["value"] == 0.0
    assert checks["match_mismatch_pct"]["value"] == 0.0
    assert checks["pose_gap_px"]["value"] < 1e-3
    for number in ("ba_gap_px", "tri_gap_rel"):
        assert checks[number]["value"] is not None, number
        assert checks[number]["value"] <= checks[number]["limit"], number
    info = res["info"]
    assert info["landmarks"] > 0 and info["keyframes"] >= 2
    assert 0 < info["keypoints_per_frame"] <= 500
    assert list(res)[-1] == "checks"
    assert res["info"]["first_pose_s"] is not None
    # The camera's one lane: nearly every frame posed, on a track that
    # lies within centimetres of the true one once aligned.
    assert res["failed"] == res["attempted"] - info["posed_frames"]
    assert info["posed_frames"] >= 0.9 * res["attempted"]
    assert info["lane_ate_m"] == [info["ate_m"]]
    assert 0 < info["ate_m"] < 0.05
    # Without a card the device's time per frame has nothing to read; the
    # host's clock is kept in the record.
    assert set(res["metrics"]) == {"setup_s"}
    assert res["info"]["host"]["frames_per_s"] > 0
    assert res["info"]["device_window"] is None
