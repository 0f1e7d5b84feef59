"""The port's dataset loaders (send_slam_tpu_torch/io/dataset.py), its
offline example and its producer's PNG frames against the JAX package.

The TUM and EuRoC trees are tests/test_dataset_e2e.py's, rebuilt here
(cv2 writes the PNGs, as there), plus a TUM tree of 8-bit RGB files as
TUM's are. Bars: frames, timestamps, ground truth and images equal
exactly (the port reads PNG itself, the JAX package through cv2); the
port's from-disk session meets test_slam_from_disk's bars (>= 20 OK,
ATE < 0.25 m) on the CPU.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from send_slam_tpu.io import dataset as jds
from send_slam_tpu.server import producers as jprod
from send_slam_tpu.utils.synth import SyntheticWorld
from send_slam_tpu_torch.config import (
    CameraConfig, EngineConfig, MapConfig, OrbConfig, TrackingConfig,
)
from send_slam_tpu_torch.io import dataset as tds
from send_slam_tpu_torch.io.evaluate import ate_rmse
from send_slam_tpu_torch.models.system import TRACKING_OK, System
from send_slam_tpu_torch.server import producers as tprod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quat_wc(R):
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R.T).as_quat()


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld()


@pytest.fixture(scope="module")
def seq_data(world):
    ts, Rs, tls = world.trajectory(n_frames=40)
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(len(ts))]
    return ts, Rs, tls, frames


def _write_tum(root, seq_data, rgb=False):
    """tests/test_dataset_e2e.py's TUM tree (``rgb``: each frame as 8-bit
    RGB, gray in three channels)."""
    ts, Rs, tls, frames = seq_data
    (root / "rgb").mkdir()
    lines = ["# color images", "# file: 'synthetic.bag'",
             "# timestamp filename"]
    for k, t in enumerate(ts):
        rel = f"rgb/{1305031102.0 + t:.6f}.png"
        img = np.repeat(frames[k][..., None], 3, 2) if rgb else frames[k]
        assert cv2.imwrite(str(root / rel), img)
        lines.append(f"{1305031102.0 + t:.6f} {rel}")
    (root / "rgb.txt").write_text("\n".join(lines) + "\n")
    gt_lines = ["# ground truth trajectory",
                "# timestamp tx ty tz qx qy qz qw"]
    for k, t in enumerate(ts):
        for half in (0.0, 0.5):
            if half and k + 1 >= len(ts):
                continue
            C = -Rs[k].T @ tls[k]
            q = _quat_wc(Rs[k])
            gt_lines.append(
                f"{1305031102.0 + t + half / 30.0 + 0.003:.6f} "
                f"{C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return root


@pytest.fixture(scope="module")
def tum_root(tmp_path_factory, seq_data):
    return _write_tum(tmp_path_factory.mktemp("tum_seq"), seq_data)


@pytest.fixture(scope="module")
def tum_rgb_root(tmp_path_factory, seq_data):
    return _write_tum(tmp_path_factory.mktemp("tum_rgb"), seq_data, rgb=True)


@pytest.fixture(scope="module")
def euroc_root(tmp_path_factory, seq_data):
    """tests/test_dataset_e2e.py's EuRoC tree (12 frames)."""
    ts, Rs, tls, frames = seq_data
    root = tmp_path_factory.mktemp("euroc_seq")
    data_dir = root / "mav0" / "cam0" / "data"
    data_dir.mkdir(parents=True)
    cam_lines = ["#timestamp [ns],filename"]
    for k, t in enumerate(ts[:12]):
        ns = int(round((1403636579.0 + t) * 1e9))
        assert cv2.imwrite(str(data_dir / f"{ns}.png"), frames[k])
        cam_lines.append(f"{ns},{ns}.png")
    (root / "mav0" / "cam0" / "data.csv").write_text(
        "\n".join(cam_lines) + "\n")
    gt_dir = root / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    gt_lines = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], ..."]
    for k, t in enumerate(ts[:12]):
        ns = int(round((1403636579.0 + t) * 1e9))
        C = -Rs[k].T @ tls[k]
        gt_lines.append(f"{ns},{C[0]},{C[1]},{C[2]}," + ",".join(["0.0"] * 13))
    (gt_dir / "data.csv").write_text("\n".join(gt_lines) + "\n")
    return root


def _assert_same_sequence(j, t):
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j)
    assert t.frames == j.frames                    # stamps and paths
    assert (t.groundtruth is None) == (j.groundtruth is None)
    if j.groundtruth is not None:
        assert t.groundtruth.dtype == j.groundtruth.dtype
        assert np.array_equal(t.groundtruth, j.groundtruth)
        for a, b in zip(t.gt_positions(), j.gt_positions()):
            assert np.array_equal(a, b)
    tf, jf = list(t), list(j)
    assert len(tf) == len(jf)
    for (tt, ti), (jt, ji) in zip(tf, jf):
        assert tt == jt
        assert ti.dtype == ji.dtype == np.uint8 and ti.shape == ji.shape
        assert np.array_equal(ti, ji)


@pytest.mark.parametrize("tree", ["tum_root", "tum_rgb_root", "euroc_root"])
def test_loaders_equal_jax(tree, request, seq_data):
    """Both packages' loaders on one tree: frames (stamps, paths), ground
    truth, gt_positions and every decoded image equal; the images equal
    the frames written."""
    root = str(request.getfixturevalue(tree))
    j, t = jds.open_sequence(root), tds.open_sequence(root)
    _assert_same_sequence(j, t)
    for (_, img), ref in zip(t, seq_data[3]):
        assert np.array_equal(img, ref)
    cls = tds.TumSequence if tree.startswith("tum") else tds.EurocSequence
    _assert_same_sequence(jds.open_sequence(root), cls(root))


def test_constants_autodetect_and_missing(tum_root, euroc_root, tmp_path):
    assert tds.TumSequence.FR1_INTRINSICS == jds.TumSequence.FR1_INTRINSICS
    assert tds.EurocSequence.CAM0_INTRINSICS == \
        jds.EurocSequence.CAM0_INTRINSICS
    assert isinstance(tds.open_sequence(str(tum_root)), tds.TumSequence)
    assert isinstance(tds.open_sequence(str(euroc_root)), tds.EurocSequence)
    for fn in (tds.open_sequence, tds.TumSequence, tds.EurocSequence):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path))
    # Without ground truth files: None, and gt_positions raises.
    (tmp_path / "rgb.txt").write_text("# no frames\n")
    (tmp_path / "mav0" / "cam0").mkdir(parents=True)
    (tmp_path / "mav0" / "cam0" / "data.csv").write_text("#ts,file\n")
    for cls in ("TumSequence", "EurocSequence"):
        t, j = getattr(tds, cls)(str(tmp_path)), getattr(jds, cls)(str(tmp_path))
        assert t.groundtruth is None and j.groundtruth is None
        assert len(t) == len(j) == 0 and list(t) == list(j) == []
        with pytest.raises(ValueError):
            t.gt_positions()


def test_unreadable_frames_are_skipped(tmp_path, seq_data):
    """A frame cv2 returns None for (missing, truncated, not a PNG) is
    skipped by both packages alike."""
    root = tmp_path / "tum"
    root.mkdir()
    _write_tum(root, (seq_data[0][:6], seq_data[1], seq_data[2],
                      seq_data[3][:6]))
    rgb = sorted((root / "rgb").iterdir())
    rgb[1].write_bytes(rgb[1].read_bytes()[:100])
    rgb[3].write_bytes(b"not a png")
    rgb[4].unlink()
    _assert_same_sequence(jds.TumSequence(str(root)),
                          tds.TumSequence(str(root)))
    assert len(list(tds.TumSequence(str(root)))) == 3


def test_slam_from_disk(tum_root, world):
    """tests/test_dataset_e2e.py's test_slam_from_disk on the port
    (device="cpu"): open_sequence -> track every frame -> ATE against the
    ground truth parsed from groundtruth.txt, at that test's bars."""
    torch.set_num_threads(2)
    seq = tds.open_sequence(str(tum_root))
    cfg = EngineConfig(
        orb=OrbConfig(n_features=512, n_levels=4),
        camera=CameraConfig(width=world.W, height=world.H,
                            fx=world.fx, fy=world.fy,
                            cx=world.cx, cy=world.cy),
        map=MapConfig(max_keyframes=32, max_landmarks=2048, ba_window=4),
        tracking=TrackingConfig(init_min_matches=50, pipeline_stretch=1),
    )
    sys_ = System(cfg, device="cpu")
    est_ts, est_pos, ok = [], [], 0
    for t, img in seq:
        out = sys_.track_monocular(img, float(t))
        if out.tracking_state == TRACKING_OK:
            ok += 1
            est_ts.append(out.timestamp)
            est_pos.append(out.position)
    assert ok >= 20, ok
    gt_ts, gt_pos = seq.gt_positions()
    err = ate_rmse(est_ts, np.asarray(est_pos), gt_ts, gt_pos)
    assert err < 0.25, err


def _run_example(script, tree, n, traj, extra=()):
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", script), str(tree),
         "--max-frames", str(n), "--traj-out", str(traj), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _frames_line(out):
    import re
    m = re.search(r"^frames: (\d+), tracked: (\d+), \S+ fps, "
                  r"keyframes: (\d+), landmarks: \d+, loops: \d+$", out, re.M)
    assert m, out
    return int(m.group(1)), int(m.group(3))


def _tum_rows(path):
    rows = [ln.split() for ln in path.read_text().splitlines() if ln.strip()]
    for r in rows:
        assert len(r) == 8
        [float(v) for v in r]
    return rows


@pytest.fixture(scope="module")
def tum_640(tmp_path_factory):
    """The example's TUM size, 640x480: the main path's first frames as
    8-bit RGB PNGs (chip_smoke.py's writer)."""
    import chip_smoke
    w = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                       fy=520.0, seed=11)
    ts, Rs, tls = w.trajectory(n_frames=40)
    n = 12
    frames = [np.round(w.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(n)]
    root = tmp_path_factory.mktemp("tum640") / "tum"
    chip_smoke.write_tum(str(root), frames, ts[:n], Rs, tls)
    return root


def test_example_runs_on_the_cpu(tum_640, tmp_path):
    """examples/run_dataset_torch.py --device cpu as a user runs it: its
    frames line, an ATE line and one TUM line per keyframe it reports."""
    proc = _run_example("run_dataset_torch.py", tum_640, 2,
                        tmp_path / "kf.txt", ("--device", "cpu"))
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    n, n_kf = _frames_line(out)
    assert n == 2
    assert "ATE RMSE:" in out or "no ground truth available" in out
    assert len(_tum_rows(tmp_path / "kf.txt")) == n_kf


@pytest.mark.slow
def test_example_against_the_reference(tum_640, tmp_path):
    """run_dataset_torch.py --device cpu --max-frames 12 beside
    run_dataset.py on the same tree: the same frame count, and keyframe
    files that parse (one TUM line per keyframe each reports)."""
    procs = [_run_example(script, tum_640, 12, tmp_path / f"{i}.txt", extra)
             for i, (script, extra) in enumerate((
                 ("run_dataset_torch.py", ("--device", "cpu")),
                 ("run_dataset.py", ())))]
    counts = []
    for i, proc in enumerate(procs):
        out, err = proc.communicate(timeout=1200)
        assert proc.returncode == 0, err[-3000:]
        n, n_kf = _frames_line(out)
        assert len(_tum_rows(tmp_path / f"{i}.txt")) == n_kf
        counts.append(n)
    assert counts == [12, 12]


def test_producer_png_frames_equal_jax(tmp_path):
    """The producer reads .png through the port's reader: a printf
    pattern and a directory of PNGs of several kinds give the JAX
    producer's (cv2.imread) frames."""
    from PIL import Image
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (14, 18, 3), dtype=np.uint8)
    imgs = [rgb[..., ::-1], rgb[..., 0],
            np.concatenate([rgb[..., ::-1], rgb[..., :1]], -1),
            rgb.astype(np.uint16)[..., ::-1] * 257]
    for k, img in enumerate(imgs):
        assert cv2.imwrite(str(tmp_path / f"{k:06d}.png"), img)
    Image.fromarray(rgb).convert("P").save(tmp_path / f"{len(imgs):06d}.png")
    (tmp_path / "000009.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    for path in (str(tmp_path / "%06d.png"), str(tmp_path)):
        t = list(tprod.VideoProducer(None, path)._frames())
        j = list(jprod.VideoProducer(None, path)._frames())
        assert len(t) == len(j) == len(imgs) + 1
        for a, b in zip(t, j):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tprod.read_image(str(tmp_path / "000009.png")) is None
