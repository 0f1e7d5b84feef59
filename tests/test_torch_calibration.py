"""The port's calibration (send_slam_tpu_torch/calib/) against the JAX
package's on the CPU, on tests/test_calibration.py's rendered boards.

Tolerances. The blur and the ring response are the same f32 operations
in the same order (1e-4 on 0-255 intensities). The NMS candidates and
their order are exact: the port sorts as ``jax.lax.top_k`` does. The
sub-pixel refinement is ten Newton steps on f32 window sums of absolute
pixel coordinates (~300 px, where an f32 ulp is 3e-5 px); XLA sums those
windows in its own order inside the jitted scan, and its corners lie
1.7e-4 to 2.4e-4 px from the float64 evaluation of the same refinement
(measured here, board by board). So the corners are held at 1e-4 plus
that measured distance of the JAX package's own, and the port must stay
as close to the float64 evaluation as the JAX package is. Zhang on exact
corners: K 1e-4 relative, the five distortion coefficients 1e-4, rms
1e-3 px.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp
from send_slam_tpu.calib import checkerboard as jcb
from send_slam_tpu.calib import pipeline as jpipe
from send_slam_tpu.calib import zhang as jz
from send_slam_tpu.ops.pyramid import gaussian_blur as jblur
from send_slam_tpu_torch import calib as tcalib
from send_slam_tpu_torch.calib import checkerboard as tcb
from send_slam_tpu_torch.calib import pipeline as tpipe
from send_slam_tpu_torch.calib import zhang as tz
from send_slam_tpu_torch.ops.pyramid import gaussian_blur as tblur
from test_calibration import (
    DIST_GT, K_GT, PATTERN, SQUARE, board_views, render_board,
)

torch.set_num_threads(1)



def refine_bar(x, ordered, ref):
    """The corner bar for the JAX package's refined corners ``ref`` of
    blurred image ``x`` from lattice ``ordered``: 1e-4 px plus their own
    distance from the float64 evaluation of the same refinement."""
    exact = tcb.refine_subpixel(
        torch.from_numpy(np.array(x, np.float64)),
        torch.from_numpy(np.array(ordered, np.float64))).numpy()
    return 1e-4 + np.abs(np.asarray(ref, np.float64) - exact).max(), exact


@pytest.fixture(scope="module")
def views():
    return board_views()


def hard_boards():
    """tests/test_calibration.py's five hard boards: oblique, defocused,
    noisy."""
    from scipy.ndimage import gaussian_filter
    cx_b, cy_b = PATTERN[0] * SQUARE / 2, PATTERN[1] * SQUARE / 2
    cases = [
        (np.array([0.6, -0.2, 0.25]),
         np.array([-cx_b, -cy_b + 10, 520.0]), 0.0, 1.0),
        (np.array([-0.15, 0.65, -0.3]),
         np.array([-cx_b + 20, -cy_b, 560.0]), 0.0, 1.0),
        (np.array([0.2, 0.15, 0.1]), np.array([-cx_b, -cy_b, 500.0]),
         2.0, 1.5),
        (np.array([0.5, 0.35, 0.2]), np.array([-cx_b, -cy_b, 540.0]),
         1.5, 2.0),
        (np.array([0.1, -0.3, 0.4]), np.array([-cx_b, -cy_b, 480.0]),
         0.8, 6.0),
    ]
    out = []
    for rvec, tvec, extra_blur, noise in cases:
        img = render_board(rvec, tvec, noise=noise, seed=7)
        if extra_blur > 0:
            img = gaussian_filter(img, extra_blur)
        out.append(img.astype(np.float32))
    return out


def jax_candidates(img):
    """The JAX package's blurred image, response, top-k and the ordered
    lattice of one board (detect_checkerboard's steps)."""
    x = jblur(jnp.asarray(img, jnp.float32), 1.5, 5)
    resp = jcb.corner_response_map(x)
    k = int(PATTERN[0] * PATTERN[1] * 1.5)
    uv, score = jcb._nms_topk(resp, k)
    uv, score = np.asarray(uv), np.asarray(score)
    keep = score > max(float(np.max(score)) * 0.2, 1e-3)
    ordered = jcb._order_into_grid(uv[keep], PATTERN, score[keep])
    return np.asarray(x), np.asarray(resp), uv, score, keep, ordered


@pytest.mark.parametrize("view", [0, 5, 11])
def test_blur_and_ring_response(views, view):
    img = views[view][2]
    x_j = np.asarray(jblur(jnp.asarray(img), 1.5, 5))
    x_t = tblur(torch.from_numpy(img), 1.5, 5).numpy()
    np.testing.assert_allclose(x_t, x_j, atol=1e-4)
    r_j = np.asarray(jcb.corner_response_map(jnp.asarray(x_j)))
    r_t = tcb.corner_response_map(torch.from_numpy(x_j)).numpy()
    np.testing.assert_allclose(r_t, r_j, atol=1e-4)


@pytest.mark.parametrize("view", [0, 7])
def test_nms_topk_candidates_and_order(views, view):
    _, resp, uv, score, _, _ = jax_candidates(views[view][2])
    k = int(PATTERN[0] * PATTERN[1] * 1.5)
    uv_t, score_t = tcb._nms_topk(torch.from_numpy(resp), k)
    np.testing.assert_array_equal(uv_t.numpy(), uv)
    np.testing.assert_array_equal(score_t.numpy(), score)


def test_nms_topk_ties_break_by_flat_index():
    """Plateaus of equal response (3x3 NMS keeps every pixel of a flat
    block) and fewer maxima than k (-inf fills the tail): the candidate
    list and its order are JAX's."""
    rng = np.random.default_rng(0)
    resp = np.zeros((60, 80), np.float32)
    for _ in range(30):
        y, x = rng.integers(8, 48), rng.integers(8, 68)
        resp[y:y + rng.integers(1, 4), x:x + rng.integers(1, 4)] = \
            rng.choice([5.0, 7.0, 9.0])
    for k in (20, 200):
        uv_j, s_j = jcb._nms_topk(jnp.asarray(resp), k)
        uv_t, s_t = tcb._nms_topk(torch.from_numpy(resp), k)
        np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_order_into_grid_exact(views):
    for view in (1, 4, 9):
        _, _, uv, score, keep, ordered = jax_candidates(views[view][2])
        got = tcb._order_into_grid(uv[keep], PATTERN, score[keep])
        np.testing.assert_array_equal(got, ordered)
    # Too few points, and a degenerate cloud, refuse alike.
    pts = np.random.default_rng(3).uniform(0, 100, (20, 2))
    assert tcb._order_into_grid(pts, PATTERN) is None
    assert jcb._order_into_grid(pts, PATTERN) is None


def test_refine_subpixel(views):
    for view in (0, 3, 8):
        x, _, _, _, _, ordered = jax_candidates(views[view][2])
        uv0 = np.asarray(ordered, np.float32)
        ref = np.asarray(jcb.refine_subpixel(jnp.asarray(x),
                                             jnp.asarray(uv0)))
        got = tcb.refine_subpixel(torch.from_numpy(x),
                                  torch.from_numpy(uv0)).numpy()
        bar, exact = refine_bar(x, uv0, ref)
        assert bar < 5e-4
        assert np.abs(got - ref).max() <= bar
        # As close to the f64 evaluation as the reference is (with a
        # margin of one f32 ulp at 512 px).
        assert np.abs(got - exact).max() \
            <= np.abs(ref - exact).max() + 6.1e-5


def test_detect_checkerboard_on_views_hard_boards_and_noise(views):
    imgs = [v[2] for v in views] + hard_boards()
    rng = np.random.default_rng(0)
    imgs.append(rng.uniform(0, 255, (480, 640)).astype(np.float32))
    for img in imgs:
        ref = jcb.detect_checkerboard(img, PATTERN)
        got = tcb.detect_checkerboard(img, PATTERN, device="cpu")
        assert (got is None) == (ref is None)
        if ref is not None:
            assert got.shape == (54, 2) and got.dtype == np.float32
            x, _, _, _, _, ordered = jax_candidates(img)
            assert np.abs(got - ref).max() <= refine_bar(x, ordered, ref)[0]
    assert got is None                  # the noise image


def exact_corners(views):
    obj = jz.make_object_points(PATTERN, SQUARE)
    obj_v, img_v = [], []
    for rvec, tvec, _ in views:
        R = Rotation.from_rotvec(rvec).as_matrix()
        p = obj @ R.T + tvec
        x, y = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
        k1, k2, p1_, p2_, k3 = DIST_GT
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1_ * x * y + p2_ * (r2 + 2 * x * x)
        yd = y * radial + p1_ * (r2 + 2 * y * y) + 2 * p2_ * x * y
        obj_v.append(obj)
        img_v.append(np.stack([K_GT[0, 0] * xd + K_GT[0, 2],
                               K_GT[1, 1] * yd + K_GT[1, 2]], -1))
    return np.asarray(obj_v), np.asarray(img_v)


def test_object_points_and_linear_init_equal(views):
    obj, img = exact_corners(views)
    np.testing.assert_array_equal(tz.make_object_points(PATTERN, SQUARE),
                                  obj[0])
    Hs_j = [jz._homography_np(obj[i][:, :2], img[i]) for i in range(3)]
    Hs_t = [tz._homography_np(obj[i][:, :2], img[i]) for i in range(3)]
    np.testing.assert_array_equal(np.asarray(Hs_t), np.asarray(Hs_j))
    np.testing.assert_array_equal(tz._zhang_intrinsics(Hs_t),
                                  jz._zhang_intrinsics(Hs_j))


def test_residual_jacobian_matches_jax(views):
    """The LM's Jacobian (torch.func.jacfwd) against jax.jacfwd at the
    linear initialisation."""
    import jax
    obj, img = exact_corners(views[:4])
    obj, img = obj.astype(np.float32), img.astype(np.float32)
    rng = np.random.default_rng(1)
    p = np.concatenate([[520, 515, 322, 238], rng.normal(0, 0.05, 5),
                        np.concatenate([np.r_[rng.normal(0, 0.3, 3),
                                              [-100, -60, 500]]
                                        for _ in range(4)])]).astype(
        np.float32)

    def jres(q):
        return jz._residuals(q, jnp.asarray(obj), jnp.asarray(img)).reshape(-1)

    J_j = np.asarray(jax.jacfwd(jres)(jnp.asarray(p)))
    J_t = torch.func.jacfwd(lambda q: tz._residuals(
        q, torch.from_numpy(obj), torch.from_numpy(img)).reshape(-1))(
        torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(J_t, J_j, rtol=1e-5,
                               atol=1e-5 * np.abs(J_j).max())


def test_calibrate_camera_on_exact_corners(views):
    obj, img = exact_corners(views)
    ref = jz.calibrate_camera(obj, img)
    got = tz.calibrate_camera(obj, img, device="cpu")
    assert set(got) == set(ref)
    K_r, K_g = ref["camera_matrix"], got["camera_matrix"]
    assert np.abs(K_g - K_r).max() / np.abs(K_r).max() <= 1e-4
    d_r, d_g = ref["distortion_coeffs"], got["distortion_coeffs"]
    assert d_g.shape == (1, 5)
    np.testing.assert_allclose(d_g, d_r, atol=1e-4)
    assert abs(got["reprojection_error"] - ref["reprojection_error"]) <= 1e-3
    assert got["successful_frames"] == ref["successful_frames"] == 12
    assert got["extrinsics"].shape == ref["extrinsics"].shape == (12, 6)
    np.testing.assert_allclose(got["extrinsics"], ref["extrinsics"],
                               atol=1e-2)
    with pytest.raises(ValueError, match=">= 3 views"):
        tz.calibrate_camera(obj[:2], img[:2], device="cpu")


def test_calibrate_end_to_end(views):
    frames = [v[2] for v in views]
    ref = jpipe.calibrate(frames, PATTERN, SQUARE)
    got = tpipe.calibrate(frames, PATTERN, SQUARE, device="cpu")
    K_r, K_g = ref["camera_matrix"], got["camera_matrix"]
    assert np.abs(K_g - K_r).max() / np.abs(K_r).max() <= 1e-4
    assert got["successful_frames"] == ref["successful_frames"] >= 10
    assert abs(got["reprojection_error"] - ref["reprojection_error"]) <= 1e-3
    for K in (K_r, K_g):
        assert abs(K[0, 0] - 520.0) / 520.0 < 0.02
        assert abs(K[1, 1] - 515.0) / 515.0 < 0.02
    # RGB frames go through the same luma weights.
    rgb = [np.stack([f, 0.5 * f, 255.0 - f], -1) for f in frames]
    ref_rgb = jpipe.calibrate(rgb, PATTERN, SQUARE)["camera_matrix"]
    got_rgb = tpipe.calibrate(rgb, PATTERN, SQUARE,
                              device="cpu")["camera_matrix"]
    assert np.abs(got_rgb - ref_rgb).max() / np.abs(ref_rgb).max() <= 1e-4


def test_too_few_detections_refused_alike():
    rng = np.random.default_rng(1)
    noise = [rng.uniform(0, 255, (480, 640)).astype(np.float32)
             for _ in range(12)]
    with pytest.raises(ValueError, match="insufficient") as e_j:
        jpipe.calibrate(noise, PATTERN, SQUARE)
    with pytest.raises(ValueError, match="insufficient") as e_t:
        tpipe.calibrate(noise, PATTERN, SQUARE, device="cpu")
    assert str(e_t.value) == str(e_j.value)


def test_package_exports_and_card_default():
    import send_slam_tpu.calib as jcalib
    names = {n for n in dir(jcalib) if not n.startswith("_")}
    names -= {"io", "checkerboard", "zhang", "pipeline"}
    assert names <= set(dir(tcalib))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcb.detect_checkerboard(np.zeros((48, 64), np.float32))


def test_example_calibrates_ppm_and_jpeg_files(views, tmp_path):
    """examples/calibrate_from_images_torch.py on the board views written
    as .pgm, colour .ppm and .jpg files (a .png is skipped), on the CPU:
    the saved JSON holds the JAX package's camera matrix of the same
    gray images."""
    import json
    import os
    import subprocess
    import sys
    from send_slam_tpu_torch.io.jpeg import decode_jpeg_gray, encode_jpeg
    from send_slam_tpu_torch.io.ppm import encode_ppm
    gray = []
    for i, (_, _, img) in enumerate(views):
        u8 = np.round(img).astype(np.uint8)
        if i % 3 == 0:
            (tmp_path / f"{i:02d}.pgm").write_bytes(encode_ppm(u8))
            gray.append(u8)
        elif i % 3 == 1:
            rgb = np.repeat(u8[..., None], 3, 2)
            (tmp_path / f"{i:02d}.ppm").write_bytes(encode_ppm(rgb))
            gray.append(u8)
        else:
            data = encode_jpeg(np.repeat(u8[..., None], 3, 2))
            (tmp_path / f"{i:02d}.jpg").write_bytes(data)
            gray.append(decode_jpeg_gray(data))
    (tmp_path / "99.png").write_bytes(b"\x89PNG\r\n")
    out = tmp_path / "latest.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "examples",
                                      "calibrate_from_images_torch.py"),
         str(tmp_path / "*.*"), "--out", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loaded 12 frames" in proc.stdout and "99.png" in proc.stderr
    saved = json.loads(out.read_text())
    K = np.asarray(saved["camera_matrix"]["data"]).reshape(3, 3)
    ref = jpipe.calibrate([g.astype(np.float32) for g in gray], PATTERN,
                          SQUARE)["camera_matrix"]
    assert np.abs(K - ref).max() / np.abs(ref).max() <= 1e-4
