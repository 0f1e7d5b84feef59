"""Per-stage timing, shutdown statistics and the engine's own spans.

The reference's measurement machinery (SURVEY.md §5): per-frame send
latency logs (slam_handler.ex:297-300), the ImageTimer FPS counter
(timer.ex:29-44), and the backend's vTimesTrack median/mean printed at
shutdown (orbslam3_mono_networked.cc:615-616, 656-664). Here one
StageTimer covers all of it, and ``device_trace`` records a
``torch.profiler`` trace of the card.

The port's own copy of ``send_slam_tpu/utils/profiling.py``;
``device_trace`` wraps ``torch.profiler`` in place of ``jax.profiler``.

Beside them, the engine's tracer: ``span`` opens a named range at a
layer boundary of the frame path (``slam.frame``, ``slam.tracking``, ...)
and ``count`` adds to a named counter (``sync.<site>`` for each explicit
device-to-host read, ``frames``, ``keyframes``, ...). Both are off until
``set_tracing(True)``; off, a span site costs one flag test. On, a span
is a ``torch.profiler.record_function`` range, so a profiler running at
the same time shows it on the timeline of the kernels, and a record
``(name, frame_id, parent_index, start_ns, end_ns)`` kept in memory until
``drain()``. The stamps are ``time.time_ns()``, the clock of the
profiler's own events. Neither a span nor a counter reads the device or
waits for it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class StageTimer:
    """Accumulates wall-time samples per named stage."""

    def __init__(self, max_samples: int = 100000):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._max = max_samples

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self._samples[name]
            if len(s) < self._max:
                s.append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        s = self._samples[name]
        if len(s) < self._max:
            s.append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._samples.items():
            if not s:
                continue
            srt = sorted(s)
            out[name] = {
                "count": len(s),
                "median_ms": srt[len(srt) // 2] * 1e3,
                "mean_ms": sum(s) / len(s) * 1e3,
                "p90_ms": srt[int(len(srt) * 0.9)] * 1e3,
                "total_s": sum(s),
            }
        return out

    def report(self) -> str:
        """The shutdown printout, like the reference backend's
        median/mean tracking time (…cc:656-664)."""
        lines = []
        for name, st in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} n={st['count']:6d} median={st['median_ms']:8.2f}ms"
                f" mean={st['mean_ms']:8.2f}ms p90={st['p90_ms']:8.2f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the block: CPU and, with a card, CUDA
    activity, written as a Chrome trace to ``logdir/trace.json``; with
    tracing on, the engine's ``slam.*`` spans are ranges in it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ----------------------------------------------------------------------
# The engine's tracer

MAX_SPANS = 1 << 20       # records kept between drains; beyond, none

_on = False
_null = contextlib.nullcontext()
_records: List[list] = []       # [name, frame_id, parent_index, start, end]
_open: List[int] = []           # indexes of the open spans, innermost last
_counts: Dict[str, int] = {}


class Trace(NamedTuple):
    """What ``drain`` hands over: the spans in the order they opened, as
    (name, frame_id, parent_index, start_ns, end_ns) with parent_index an
    index into the same list (None for a root), and the counters."""

    spans: List[Tuple[str, Optional[int], Optional[int], int, int]]
    counts: Dict[str, int]


def set_tracing(on: bool) -> None:
    """Turn the engine's spans and counters on or off (off at import)."""
    global _on
    _on = bool(on)


def tracing() -> bool:
    return _on


class _Span:
    __slots__ = ("_rf", "_rec")

    def __init__(self, name: str, frame: Optional[int]):
        parent = _open[-1] if _open else None
        if frame is None and parent is not None:
            frame = _records[parent][1]
        self._rec = [name, frame, parent, 0, 0]
        self._rf = torch.profiler.record_function(name)

    # The stamps enclose the profiler's range: it stamps its start first
    # thing on entry, which can take a millisecond the first time.
    def __enter__(self):
        rec = self._rec
        rec[3] = time.time_ns()
        self._rf.__enter__()
        if len(_records) < MAX_SPANS:
            _open.append(len(_records))
            _records.append(rec)
        return self

    def __exit__(self, *exc):
        if _open and _records[_open[-1]] is self._rec:
            _open.pop()
        self._rf.__exit__(*exc)
        self._rec[4] = time.time_ns()
        return False


def span(name: str, frame: Optional[int] = None):
    """A range around a layer's work. ``frame`` is the camera frame the
    work is for; left out, the enclosing span's. Off, the one shared
    null context."""
    if not _on:
        return _null
    return _Span(name, frame)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (tracing on only). ``n`` must be
    a value the host already holds."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def drain() -> Trace:
    """The spans and the counters so far, both then cleared. Drain
    between frames: a span still open is handed over with end_ns 0, and
    spans opened inside it afterwards are roots."""
    spans = [tuple(r) for r in _records]
    counts = dict(_counts)
    _records.clear()
    _open.clear()
    _counts.clear()
    return Trace(spans, counts)
