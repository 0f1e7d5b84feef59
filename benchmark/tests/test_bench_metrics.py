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
    assert _reader("tum_fr1.steady", "host.frames_per_s")(run) == \
        pytest.approx(0.4)


def test_p95_is_over_every_call():
    ms = list(range(1, 101))
    calls, t = [], 0.0
    for m in ms:
        calls.append((t, t + m / 1e3))
        t += m / 1e3
    run = Run(setup_s=1.0, window_s=t, first_pose_s=None, calls=calls)
    got = _reader("tum_fr1.steady", "host.frame_ms_p95")(run)
    assert got == pytest.approx(np.percentile(ms, 95))
    # Stalls move it: the tail is not taken over tracked frames only.
    calls[3] = (calls[3][0], calls[3][0] + 5.0)
    calls[7] = (calls[7][0], calls[7][0] + 5.0)
    calls[9] = (calls[9][0], calls[9][0] + 5.0)
    calls[11] = (calls[11][0], calls[11][0] + 5.0)
    calls[13] = (calls[13][0], calls[13][0] + 5.0)
    calls[15] = (calls[15][0], calls[15][0] + 5.0)
    assert _reader("tum_fr1.steady", "host.frame_ms_p95")(run) > 1000


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
    cell = small_cell("tum_fr1.steady", width=160, height=120, lap=6)
    driver = cell.driver()
    drv = driver.Driver(None, driver.generate(cell.traffic, cell.config),
                        "cpu")
    drv.system = _ScriptedSystem()
    steps = [drv.step() for _ in range(6)]
    assert [posed for _, posed in steps] == [False, False, False, True,
                                             True, True]
    assert [n for n, _ in steps] == [1] * 6


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


def test_a_call_counts_the_camera_frames_it_handed_over():
    run = Run(setup_s=1.0, window_s=10.0, first_pose_s=2.0,
              calls=[(0, 4), (4, 10)], call_frames=[2, 2])
    assert run.frames() == 4
    assert _reader("tum_fr1.steady", "host.frames_per_s")(run) == \
        pytest.approx(0.4)


MS = 1_000_000


def test_device_time_is_the_union_over_every_frame():
    """The C library merges the device intervals: overlaps count once;
    the reader spreads the union over every frame of the window and
    reads nothing where a record was dropped."""
    import ctypes
    from harness import devclock
    lib = ctypes.CDLL(str(devclock.build()))
    lib.dc_add.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.dc_reset()
    for s, e in [(10 * MS, 11 * MS), (0, 2 * MS), (1 * MS, 3 * MS),
                 (2 * MS, 2 * MS + 500)]:
        lib.dc_add(s, e)
    got = devclock.busy(lib)
    assert got["busy_s"] == pytest.approx(4e-3)
    assert got["events"] == 4 and got["dropped"] == 0 and not got["failed"]
    lib.dc_reset()
    assert devclock.busy(lib)["events"] == 0
    read = _reader("tum_fr1.steady", "device_ms_per_frame")
    run = Run(setup_s=1.0, window_s=0.02, first_pose_s=None,
              calls=[(0, 0.005), (0.005, 0.012)], call_frames=[1, 1],
              device=got)
    assert read(run) == pytest.approx(2.0)
    run.device = dict(got, dropped=3)
    assert read(run) is None
    run.device = None
    assert read(run) is None


def test_a_range_on_the_device_is_no_launch_and_no_busy_time():
    """The profiler's device-side annotation of a ``slam.*`` range covers
    the kernels under it: it is neither a launch nor busy time, and the
    gap under the range goes to the range."""
    events = [("kernel_a", True, 0, 1 * MS), ("kernel_b", True, 5 * MS,
                                               6 * MS),
              ("slam.tracking", False, 0, 6 * MS)]
    plain = trace.summarize(events, wall_s=0.01)
    annotated = trace.summarize(
        events + [("slam.tracking", True, 0, 6 * MS)], wall_s=0.01)
    assert annotated["launches"] == plain["launches"] == 2
    assert annotated["busy_s"] == plain["busy_s"] == pytest.approx(2e-3)
    assert dict(annotated["device_ops"]) == dict(plain["device_ops"])
    assert dict(annotated["idle_gaps"]) == {"slam.tracking":
                                            pytest.approx(4e-3)}
    assert annotated["idle_by_range"] == pytest.approx(
        {"slam.tracking": 4e-3, "": 0.0})


def test_without_ranges_the_gaps_are_named_as_before():
    events = [("kernel_a", True, 0, 1 * MS), ("kernel_b", True, 5 * MS,
                                               6 * MS)]
    s = trace.summarize(events, wall_s=0.01)
    assert dict(s["idle_gaps"]) == {"host (no traced call)":
                                    pytest.approx(4e-3)}
    assert s["idle_by_range"] is None


def test_readers_of_the_programs_ranges_and_counters():
    # Kernels at 0-1, 3-4, 6-7, 10-11, 20-21, 23-24, 30-31 ms under the
    # ranges of tests/test_bench_program.py's two frames.
    kernels = [(f"k{i}", True, s * MS, e * MS) for i, (s, e) in enumerate(
        [(0, 1), (3, 4), (6, 7), (10, 11), (20, 21), (23, 24), (30, 31)])]
    ranges = [("slam.frame", False, 0, 12 * MS),
              ("slam.tracking", False, int(1.5 * MS), int(5.5 * MS)),
              ("slam.mapping", False, 8 * MS, 9 * MS),
              ("slam.frame", False, 18 * MS, 29 * MS),
              ("slam.frontend", False, int(21.5 * MS), int(22.5 * MS)),
              ("slam.lagged", False, 25 * MS, 29 * MS),
              ("slam.loop", False, 27 * MS, 28 * MS)]
    s = trace.summarize(kernels + ranges, wall_s=0.031)
    run = Run(setup_s=0, calls=[(0, 0.01), (0.01, 0.031)], window_s=0.031,
              first_pose_s=None, trace=dict(s, frames=2),
              program_spans=[], counters={"sync.need_kf": 3,
                                          "sync.track_inliers": 2,
                                          "frames": 2, "keyframes": 1})
    r = _reader
    assert r("tum_fr1.steady", "tracking.idle_ms_per_frame")(run) == \
        pytest.approx(2.0)                       # 1-3, 4-6 ms
    assert r("tum_fr1.steady", "mapping.idle_ms_per_frame")(run) == \
        pytest.approx(1.5)                       # 7-10 ms
    assert r("tum_fr1.steady", "frontend.idle_ms_per_frame")(run) == \
        pytest.approx(1.0)                       # 21-23 ms
    assert r("tum_fr1.steady", "host.orchestration_idle_ms_per_frame")(
        run) == pytest.approx(3.0)               # the loop's 24-30 ms
    assert r("tum_fr1.steady", "device.untraced_idle_pct")(run) == \
        pytest.approx(100 * 9 / 24)              # 11-20 of 24 ms idle
    assert r("tum_fr1.steady", "host.named_syncs_per_frame")(run) == 2.5
    # slam.polish counts as mapping.
    polish = trace.summarize(
        kernels + [("slam.polish" if n == "slam.mapping" else n, d, s0, s1)
                   for n, d, s0, s1 in ranges], wall_s=0.031)
    run.trace = dict(polish, frames=2)
    assert r("tum_fr1.steady", "mapping.idle_ms_per_frame")(run) == \
        pytest.approx(1.5)


@pytest.mark.parametrize("name", [
    "tracking.idle_ms_per_frame", "frontend.idle_ms_per_frame",
    "mapping.idle_ms_per_frame", "host.orchestration_idle_ms_per_frame",
    "device.untraced_idle_pct", "host.named_syncs_per_frame"])
def test_without_the_programs_tracer_its_readers_read_nothing(name):
    s = trace.summarize([("kernel_a", True, 0, MS),
                         ("kernel_b", True, 3 * MS, 4 * MS)], wall_s=0.01)
    run = Run(setup_s=0, calls=[(0, 0.01)], window_s=0.01,
              first_pose_s=None, trace=dict(s, frames=1))
    assert _reader("tum_fr1.steady", name)(run) is None
