"""The readers: a rate over the whole window, a tail over every call, the
first pose counting backfilled poses, and the trace's reductions."""

import numpy as np
import pytest

from bench_helpers import small_cell
from harness import trace
from harness.record import Run


def _reader(cell_name, metric):
    cell = small_cell(cell_name)
    for kind in ("end_to_end", "per_layer"):
        for m in cell.metrics(kind):
            if m["name"] == metric:
                return cell.reader(m)
    raise KeyError(metric)


def test_rate_is_over_the_whole_window():
    # The last call ends at 10 s: 4 frames / 10 s, the slow last call
    # included.
    run = Run(setup_s=1.0, window_s=10.0, first_pose_s=2.0,
              calls=[(0, 1), (1, 2), (2, 3), (3, 10)])
    assert _reader("tum_fr1.steady", "frames_per_s")(run) == \
        pytest.approx(0.4)


def test_p95_is_over_every_call():
    ms = list(range(1, 101))
    calls, t = [], 0.0
    for m in ms:
        calls.append((t, t + m / 1e3))
        t += m / 1e3
    run = Run(setup_s=1.0, window_s=t, first_pose_s=None, calls=calls)
    got = _reader("tum_fr1.steady", "frame_ms_p95")(run)
    assert got == pytest.approx(np.percentile(ms, 95))
    # Stalls move it: the tail is not taken over tracked frames only.
    calls[3] = (calls[3][0], calls[3][0] + 5.0)
    calls[7] = (calls[7][0], calls[7][0] + 5.0)
    calls[9] = (calls[9][0], calls[9][0] + 5.0)
    calls[11] = (calls[11][0], calls[11][0] + 5.0)
    calls[13] = (calls[13][0], calls[13][0] + 5.0)
    calls[15] = (calls[15][0], calls[15][0] + 5.0)
    assert _reader("tum_fr1.steady", "frame_ms_p95")(run) > 1000


class _Out:
    def __init__(self, state, position=None, backfill=()):
        self.tracking_state, self.position, self.backfill = \
            state, position, backfill


class _ScriptedSystem:
    """Initialising for three calls, then one call whose only poses are
    backfilled (a held pose released late), then live poses."""

    def __init__(self):
        self.k = 0

    def track_monocular(self, img, ts):
        self.k += 1
        if self.k <= 3:
            return _Out(1)
        if self.k == 4:
            return _Out(1, None, ((0.1, np.zeros(3), np.zeros(4)),))
        return _Out(2, np.zeros(3))


def test_first_pose_counts_a_backfilled_pose():
    from harness.driver import Driver
    from harness.traffic import generate
    cell = small_cell("tum_fr1.steady", width=160, height=120, lap=6)
    drv = Driver(None, generate(cell.traffic, cell.config), "cpu")
    drv.system = _ScriptedSystem()
    assert [drv.step() for _ in range(6)] == [False, False, False, True,
                                              True, True]


def test_trace_summary_counts_and_gaps():
    ns = 1_000_000
    events = [
        ("kernel_a", True, 0, 2 * ns), ("kernel_b", True, 1 * ns, 3 * ns),
        ("Memcpy DtoH (Device -> Pageable)", True, 5 * ns, 6 * ns),
        ("Memcpy HtoD (Pageable -> Device)", True, 8 * ns, 9 * ns),
        ("fast_levels_kernel(Table)", True, 10 * ns, 11 * ns),
        ("cudaStreamSynchronize", False, 4 * ns, 6 * ns),
        ("aten::index", False, 3 * ns, 5 * ns),
        ("python", False, 0, 12 * ns),
    ]
    s = trace.summarize(events, wall_s=0.012)
    assert s["launches"] == 3
    assert s["sync_calls"] == 1 and s["d2h_copies"] == 1
    assert s["busy_s"] == pytest.approx(6e-3)
    gaps = dict(s["idle_gaps"])
    # 3-5 ms: the innermost host call covering 4 ms is the sync...
    assert gaps["cudaStreamSynchronize"] == pytest.approx(2e-3)
    # ...then the outer one covers 6-8 and 9-10 ms.
    assert gaps["python"] == pytest.approx(3e-3)
    run = Run(setup_s=0, calls=[], window_s=1, first_pose_s=None,
              trace=dict(s, frames=2), fast_bound_ms=0.25)
    assert _reader("tum_fr1.steady", "host.launches_per_frame")(run) == 1.5
    assert _reader("tum_fr1.steady", "host.syncs_per_frame")(run) == 1.0
    assert _reader("tum_fr1.steady", "fast.roofline_pct")(run) == \
        pytest.approx(25.0)
    assert _reader("tum_fr1.steady", "device.idle_pct")(run) == \
        pytest.approx(50.0)


def test_readers_of_spans():
    spans = [("frontend", "make_frame", 0.0, 0.02),
             ("frontend", "make_frame", 1.0, 1.03),
             ("tracking", "track_frame", 0.1, 0.16),
             ("mapping", "insert_keyframe_with_triangulation", 0.2, 0.3),
             ("mapping", "local_bundle_adjustment", 0.3, 0.5),
             ("mapping", "local_bundle_adjustment", 1.3, 1.4),
             ("init", "two_view_init", 0.0, 0.05),
             ("init", "System._backfill_step", 0.5, 0.9),
             ("init", "two_view_init", 3.0, 3.1)]
    run = Run(setup_s=0, calls=[], window_s=4, first_pose_s=1.0,
              spans=spans, span_frames=4)
    r = _reader
    assert r("tum_fr1.steady", "frontend.ms_per_frame")(run) == \
        pytest.approx(12.5)
    assert r("tum_fr1.steady", "tracking.ms_per_frame")(run) == \
        pytest.approx(15.0)
    assert r("tum_fr1.steady", "mapping.ms_per_keyframe")(run) == \
        pytest.approx(400.0)
    assert r("tum_fr1.steady", "init.ms")(run) == pytest.approx(450.0)
