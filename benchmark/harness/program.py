"""The program's own ranges in a profiler window: each ``slam.*`` span of
the engine's tracer (``send_slam_tpu_torch/utils/profiling.py``) is a
``record_function`` range, a host event on the clock of the device's.
An idle gap of the device (between two device intervals) is put down to
the innermost such range that covers its midpoint, or to none: the
caller's own loop, or code the spans miss.

``attribute`` takes the events as ``harness/trace.py`` reads them,
``(name, on_device, start_ns, end_ns)``. A window with no ``slam.*``
range (the program traced nothing, or has no tracer) attributes nothing.

A traced run switches the tracer (``tracer()``) on for its profiler
window only, and keeps what it recorded there: its spans and its
counters (``sync.<site>``, one per explicit device-to-host read, and
others).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence, Tuple

from harness.trace import _union

PREFIX = "slam."
UNTRACED = ""             # the key of the idle time under no range
TRACER = "send_slam_tpu_torch.utils.profiling"
SYNC = "sync."            # the counters of the program's host waits


def tracer():
    """The program's tracer module (``set_tracing``, ``drain``), or None
    where the program has none."""
    try:
        mod = importlib.import_module(TRACER)
    except ImportError:
        return None
    if not (hasattr(mod, "set_tracing") and hasattr(mod, "drain")):
        return None
    return mod


def is_range(name: str) -> bool:
    return name.startswith(PREFIX)


def ranges(events) -> List[Tuple[int, int, str]]:
    """(start, end, name) of the window's host ``slam.*`` ranges, by start
    (an outer range before an inner one that starts with it)."""
    return sorted(((s, e, n) for n, dev, s, e in events
                   if not dev and is_range(n)), key=lambda r: (r[0], -r[1]))


def innermost(points: Sequence[int],
              spans: Sequence[Tuple[int, int, str]]) -> List[Optional[str]]:
    """For each point (ascending), the name of the innermost range that
    covers it, or None. The ranges nest, as one thread's do."""
    out: List[Optional[str]] = []
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for x in points:
        while i < len(spans) and spans[i][0] <= x:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(events) -> Optional[Dict[str, float]]:
    """Seconds of the device's idle gaps per innermost ``slam.*`` range
    (``UNTRACED`` for the gaps under none), or None where the window has
    no such range. A device-side copy of a range (the profiler's
    annotation of the kernels under it) is no device work."""
    spans = ranges(events)
    if not spans:
        return None
    busy = _union([(s, e) for n, dev, s, e in events
                   if dev and not is_range(n)])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    out: Dict[str, float] = {UNTRACED: 0.0}
    for (s, e), name in zip(gaps, innermost([(s + e) // 2 for s, e in gaps],
                                             spans)):
        key = UNTRACED if name is None else name
        out[key] = out.get(key, 0.0) + (e - s) * 1e-9
    return out


def idle_ms_per_frame(run, names) -> Optional[float]:
    """ms a camera frame of the profiler window in which the device sat
    idle under one of the ``slam.*`` ranges ``names`` (innermost); None
    where the window has no range."""
    t = run.trace
    idle = t.get("idle_by_range") if t else None
    if idle is None or not t["frames"]:
        return None
    return sum(idle.get(n, 0.0) for n in names) * 1e3 / t["frames"]
