"""The traffic generator: seeded, and the radtan renderer's pinhole case."""

import numpy as np

from bench_helpers import small_cell
from harness.traffic import generate
from harness.world import SyntheticWorld, lap_poses


def _small():
    return small_cell("tum_fr1.steady", width=160, height=120, lap=12)


def test_the_traffic_is_one_recording():
    cell = _small()
    a = generate(cell.traffic, cell.config)
    b = generate(cell.traffic, cell.config)
    assert a.frames.dtype == np.uint8 and a.frames.shape == (12, 120, 160)
    assert np.array_equal(a.frames, b.frames)
    assert np.array_equal(a.centres, b.centres)
    # The file's world seed gives the scene; the path stays.
    c = generate(dict(cell.traffic, world_seed=12), cell.config)
    assert not np.array_equal(a.frames, c.frames)
    assert np.array_equal(a.centres, c.centres)


def test_worker_processes_render_the_same_frames():
    cell = _small()
    a = generate(cell.traffic, cell.config, workers=0)
    b = generate(cell.traffic, cell.config, workers=3)
    assert np.array_equal(a.frames, b.frames)


def test_radtan_without_distortion_is_the_pinhole_copy():
    w = SyntheticWorld(n_points=900, seed=3, width=640, height=480,
                       fx=520.0, fy=520.0)
    R, t, _ = lap_poses(300, 1.0)
    for k in (0, 75, 150, 299):
        a = w.render(R[k], t[k])
        b = w.render_radtan(R[k], t[k], 520.0, 520.0, 320.0, 240.0, [0.0] * 5)
        assert np.array_equal(a, b)


def test_radtan_moves_blobs_where_the_model_says():
    w = SyntheticWorld(n_points=1, seed=3, width=640, height=480,
                       fx=520.0, fy=520.0)
    w.points = np.array([[1.2, -0.8, 4.0]])
    w.size_at_1m = np.array([12.0])
    R, t = np.eye(3), np.zeros(3)
    dist = [0.26, -0.95, -0.005, 0.003, 1.16]
    img = w.render_radtan(R, t, 520.0, 520.0, 320.0, 240.0, dist)
    x, y = 0.3, -0.2
    r2 = x * x + y * y
    rad = 1 + r2 * (dist[0] + r2 * (dist[1] + r2 * dist[4]))
    xd = x * rad + 2 * dist[2] * x * y + dist[3] * (r2 + 2 * x * x)
    yd = y * rad + dist[2] * (r2 + 2 * y * y) + 2 * dist[3] * x * y
    ys, xs = np.nonzero(img > 20.5)
    assert abs(xs.mean() + 0.5 - (520 * xd + 320)) < 0.6
    assert abs(ys.mean() + 0.5 - (520 * yd + 240)) < 0.6


def test_lap_closes_and_stamps_count_on():
    R, t, c = lap_poses(300, 1.0)
    assert c.shape == (300, 3)
    assert np.allclose(c[0], 0) and c[:, 0].max() > 1.59
    cell = _small()
    tr = generate(dict(cell.traffic, start_frame=5), cell.config)
    assert tr.stamp(tr.lap + 3) == (tr.lap + 3) / 30.0
    assert tr.index(0) == 5 and tr.index(tr.lap - 5) == 0
