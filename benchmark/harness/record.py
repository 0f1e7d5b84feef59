"""What one run recorded, as the metric readers see it. Times are seconds
from the window's start."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Run:
    setup_s: float
    # Every call of the window: (start, end).
    calls: List[Tuple[float, float]]
    window_s: float
    # End of the first call that returned a pose, or None.
    first_pose_s: Optional[float]
    # The camera frames each call handed over; left empty, one each.
    call_frames: List[int] = dataclasses.field(default_factory=list)
    # Traced run: spans (name, target, start, end) and the camera frames
    # handed over while they were installed.
    spans: List[Tuple[str, str, float, float]] = dataclasses.field(
        default_factory=list)
    span_frames: int = 0
    # Traced run: the profiler window's summary (harness/trace.py), with
    # "frames", and the FAST bound per launch on the frames it served.
    trace: Optional[Dict] = None
    fast_bound_ms: Optional[float] = None
    # Traced run, where the program has a tracer: its spans over the
    # profiler window, (name, frame, start, end), and its counters there.
    program_spans: Optional[List[Tuple[str, Optional[int], float,
                                       float]]] = None
    counters: Optional[Dict[str, int]] = None
    # Untraced run whose end-to-end metrics read the device: its activity
    # over the whole window (harness/trace.py DeviceClock): busy_s,
    # events, last_s (the last one's end, from the window's start).
    device: Optional[Dict] = None

    def span_ms(self, name: str, target_suffix: str = "") -> List[float]:
        return [(e - s) * 1e3 for n, t, s, e in self.spans
                if n == name and t.endswith(target_suffix)]

    def frames(self) -> int:
        """Camera frames handed over in the window."""
        return sum(self.call_frames) if self.call_frames else len(self.calls)
