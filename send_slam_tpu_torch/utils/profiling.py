"""Per-stage timing + shutdown statistics.

The reference's measurement machinery (SURVEY.md §5): per-frame send
latency logs (slam_handler.ex:297-300), the ImageTimer FPS counter
(timer.ex:29-44), and the backend's vTimesTrack median/mean printed at
shutdown (orbslam3_mono_networked.cc:615-616, 656-664). Here one
StageTimer covers all of it, and ``device_trace`` records a
``torch.profiler`` trace of the card.

The port's own copy of ``send_slam_tpu/utils/profiling.py``;
``device_trace`` wraps ``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List


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
    activity, written as a Chrome trace to ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
