"""The engine's tracer (``utils/profiling.py`` ``span`` / ``count``): off
by default and free when off, nesting and frame ids, counters, one clock
with ``torch.profiler``'s events, and a CPU session that computes the
same bits with tracing on as off. Also: every function the benchmark's
outside spans name (``benchmark/spans/*.json``) still resolves and is
still called through ``models.system``'s module attributes."""

import functools
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from send_slam_tpu_torch import config as C
from send_slam_tpu_torch.models import system as tsys
from send_slam_tpu_torch.models.map_state import map_to_numpy
from send_slam_tpu_torch.utils import profiling
from send_slam_tpu_torch.utils.synth import SyntheticWorld

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SPAN_TARGETS = sorted(
    tuple(t) for f in (ROOT / "benchmark" / "spans").glob("*.json")
    for t in json.loads(f.read_text())["targets"])
N_FRAMES = 40


@pytest.fixture
def tracing():
    """Tracing on for the test, off and drained after it."""
    profiling.drain()
    profiling.set_tracing(True)
    try:
        yield
    finally:
        profiling.set_tracing(False)
        profiling.drain()


def _slam_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("slam.")]


def test_off_at_import():
    code = ("from send_slam_tpu_torch.utils import profiling as p\n"
            "print(p.tracing())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_off_records_nothing_and_emits_no_range():
    assert not profiling.tracing()
    assert profiling.span("slam.frame", 3) is profiling.span("slam.tracking")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("slam.frame", 0):
            with profiling.span("slam.tracking"):
                torch.ones(4).sum()
            profiling.count("sync.need_kf")
            profiling.count("inliers", 120)
    assert _slam_events(prof) == []
    assert profiling.drain() == ([], {})


def test_nesting_frames_and_parents(tracing):
    with profiling.span("slam.frame", 7):
        with profiling.span("slam.frontend"):
            pass
        with profiling.span("slam.tracking"):
            pass
        with profiling.span("slam.lagged", 5):
            with profiling.span("slam.loop"):
                pass
    with profiling.span("slam.frame", 8):
        pass
    spans = profiling.drain().spans
    got = [(n, f, p) for n, f, p, _s, _e in spans]
    assert got == [("slam.frame", 7, None), ("slam.frontend", 7, 0),
                   ("slam.tracking", 7, 0), ("slam.lagged", 5, 0),
                   ("slam.loop", 5, 3), ("slam.frame", 8, None)]
    for n, f, p, s, e in spans:
        assert 0 < s <= e
        if p is not None:
            assert spans[p][3] <= s and e <= spans[p][4]
    assert profiling.drain() == ([], {})


def test_counters_accumulate_and_drain_clears(tracing):
    profiling.count("sync.need_kf")
    profiling.count("sync.need_kf")
    profiling.count("inliers", 250)
    profiling.count("inliers", 31)
    assert profiling.drain().counts == {"sync.need_kf": 2, "inliers": 281}
    assert profiling.drain().counts == {}
    profiling.count("frames")
    assert profiling.drain().counts == {"frames": 1}


def test_span_stamps_share_the_profilers_clock(tracing):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("slam.clock"):
            torch.ones(8).sum()
    (ev,) = _slam_events(prof)
    ((name, _f, _p, s, e),) = profiling.drain().spans
    assert name == "slam.clock"
    assert abs(s - ev.start_ns()) < 1_000_000
    assert abs(e - ev.end_ns()) < 1_000_000


def test_device_trace_carries_the_ranges(tracing, tmp_path):
    with profiling.device_trace(str(tmp_path / "tr")):
        with profiling.span("slam.frame", 0):
            with profiling.span("slam.tracking"):
                torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"slam.frame", "slam.tracking"} <= names


@pytest.mark.parametrize("module,attr", SPAN_TARGETS,
                         ids=[f"{m}:{a}" for m, a in SPAN_TARGETS])
def test_benchmark_span_targets_resolve(module, attr):
    owner = importlib.import_module(module)
    for part in attr.split("."):
        owner = getattr(owner, part)
    assert callable(owner)


def _engine_cfg():
    return C.EngineConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4),
        camera=C.CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                              cx=160.0, cy=120.0),
        map=C.MapConfig(max_keyframes=32, max_landmarks=4096, ba_window=6),
        tracking=C.TrackingConfig(init_min_matches=40))


@pytest.fixture(scope="module")
def seq():
    w = SyntheticWorld(n_points=600, width=320, height=240, fx=260.0,
                       fy=260.0)
    ts, Rs, tls = w.trajectory(n_frames=N_FRAMES)
    return ts, [np.round(w.render(Rs[k], tls[k])).astype(np.uint8)
                for k in range(N_FRAMES)]


def _session(seq, on, called=None):
    """The sequence through a fresh System with tracing ``on``; the
    benchmark's span targets counted (in ``called``) through the module
    attributes, as the benchmark's outside spans patch them."""
    ts, imgs = seq
    saved = []
    if called is not None:
        for mod_name, path in SPAN_TARGETS:
            owner = importlib.import_module(mod_name)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            orig = owner.__dict__[attr]

            def wrap(fn, key=(mod_name, path)):
                @functools.wraps(fn)
                def counted(*a, **kw):
                    called[key] = called.get(key, 0) + 1
                    return fn(*a, **kw)
                return counted

            saved.append((owner, attr, orig))
            setattr(owner, attr, staticmethod(wrap(orig.__func__))
                    if isinstance(orig, staticmethod) else wrap(orig))
    profiling.drain()
    profiling.set_tracing(on)
    try:
        s = tsys.System(_engine_cfg(), device="cpu")
        pipelined, outs = [], []
        for k in range(N_FRAMES):
            pipelined.append(s.state in (tsys.TRACKING_OK,
                                         tsys.TRACKING_RECENTLY_LOST))
            outs.append(s.track_monocular(imgs[k], float(ts[k])))
        outs += s.shutdown()
    finally:
        profiling.set_tracing(False)
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)
    return s, outs, pipelined, profiling.drain()


@pytest.fixture(scope="module")
def sessions(seq):
    called = {}
    return (_session(seq, False), _session(seq, True, called), called)


def test_tracing_changes_no_bit(sessions):
    (s0, outs0, _, trace0), (s1, outs1, _, _), _ = sessions
    assert trace0 == ([], {})
    assert s1.calls == s0.calls == N_FRAMES
    m0, m1 = map_to_numpy(s0.map), map_to_numpy(s1.map)
    assert m0.keys() == m1.keys()
    for k in m0:
        assert np.array_equal(m0[k], m1[k], equal_nan=True), k
    assert len(outs0) == len(outs1)
    for a, b in zip(outs0, outs1):
        assert a.tracking_state == b.tracking_state
        assert a.timestamp == b.timestamp and a.n_inliers == b.n_inliers
        for x, y in ((a.position, b.position),
                     (a.orientation, b.orientation)):
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(x, y)
    for (ta, pa, qa), (tb, pb, qb) in zip(s0.trajectory(), s1.trajectory()):
        assert ta == tb and np.array_equal(pa, pb) and np.array_equal(qa, qb)
    assert len(s0.trajectory()) == len(s1.trajectory()) >= N_FRAMES // 2


def test_a_traced_session_has_its_spans(sessions):
    _, (s, _outs, pipelined, trace), _ = sessions
    spans = trace.spans
    depth = s.cfg.tracking.pipeline_depth
    # One root a call, then shutdown's drain of the frames in flight.
    roots = [i for i, sp in enumerate(spans) if sp[2] is None]
    assert [spans[i][0] for i in roots[N_FRAMES:]] == ["slam.lagged"] * depth
    roots = roots[:N_FRAMES]
    assert [spans[i][0] for i in roots] == ["slam.frame"] * N_FRAMES
    assert [spans[i][1] for i in roots] == list(range(N_FRAMES))
    below = {i: set() for i in roots}
    for n, f, p, _s, _e in spans:
        if p is None:
            continue
        while spans[p][2] is not None:
            p = spans[p][2]
        below.setdefault(p, set()).add(n)
    assert sum(pipelined) >= N_FRAMES // 2
    for i, piped in zip(roots, pipelined):
        assert "slam.frontend" in below[i]
        assert ("slam.tracking" in below[i]) if piped else \
            ({"slam.init", "slam.reloc"} & below[i])
    lagged = [(f, spans[p][1]) for n, f, p, _s, _e in spans
              if n == "slam.lagged" and p is not None]
    assert lagged and all(f == fp - depth for f, fp in lagged)
    assert [f for n, f, p, _s, _e in spans if n == "slam.lagged"
            and p is None] == list(range(N_FRAMES - depth, N_FRAMES))
    # The init's backfill tracks under the commit.
    assert any(n == "slam.tracking" and spans[p][0] == "slam.init"
               for n, _f, p, _s, _e in spans)
    c = trace.counts
    assert c["frames"] == N_FRAMES
    assert c["sync.lagged_summary"] == len(lagged) + depth
    assert c["sync.need_kf"] == sum(pipelined)
    assert c["sync.track_inliers"] >= sum(pipelined)
    assert c["keyframes"] >= 3 and c["inliers"] > 0 and c["ba_slices"] > 0


def test_outside_span_targets_are_called_through_module_attributes(
        sessions):
    _, _, called = sessions
    assert set(called) == set(SPAN_TARGETS), set(SPAN_TARGETS) - set(called)
