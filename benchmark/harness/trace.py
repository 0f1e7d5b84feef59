"""One ``torch.profiler`` window over the traced run's steady frames, read
into the counts and intervals the per-layer readers take.

Device events are the profiler's CUDA-side events: kernels, and the
copies and fills named ``Memcpy ...`` / ``Memset ...``. Host events are
the runtime's calls and the operators on the host. Everything is read
from the Kineto results directly (no event tree is built), so a window
of some hundred thousand events reads in seconds. The program's own
``slam.*`` ranges (``harness/program.py``) are host events; the
profiler's device-side annotation of one is no device work.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


class Window:
    def __init__(self, sync=None):
        self.sync = torch.cuda.synchronize if sync is None else sync
        self._prof = None
        self._t0 = 0.0
        self.wall_s = 0.0
        self.frames = 0

    def start(self) -> None:
        self.sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> Dict:
        self.sync()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        out = summarize(_events(self._prof), self.wall_s)
        out["frames"] = self.frames
        self._prof = None
        return out


def _ns(e, which):
    f = getattr(e, which + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, which + "_us")() * 1000)


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on_device, start_ns, end_ns) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        s = _ns(e, "start")
        end = getattr(e, "end_ns", None)
        end = int(end()) if end is not None else s + _ns(e, "duration")
        out.append((e.name(), dev, s, end))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events, wall_s: float) -> Dict:
    """Counts, busy time, kernel times by name and the idle gaps, each gap
    named by the innermost host event that covers its middle (among the
    400 that started last before it, else the innermost ``slam.*``
    range), and the idle seconds by ``slam.*`` range
    (``idle_by_range``: ``program.attribute``, None without ranges)."""
    from harness import program
    dev = [(n, s, e) for n, d, s, e in events
           if d and not program.is_range(n)]
    host = sorted((s, e, n) for n, d, s, e in events if not d)
    kernels = [(n, s, e) for n, s, e in dev
               if not n.startswith(("Memcpy", "Memset"))]
    by_kernel: Dict[str, List[float]] = collections.defaultdict(list)
    for n, s, e in kernels:
        by_kernel[n].append((e - s) * 1e-9)
    syncs = sum(1 for s, e, n in host if n in SYNC_CALLS)
    d2h = sum(1 for n, s, e in dev if n.startswith("Memcpy DtoH"))
    busy = _union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9

    starts = [h[0] for h in host]
    gaps = collections.Counter()
    pairs = list(zip(busy, busy[1:]))
    mids = [(e0 + s1) // 2 for (_, e0), (s1, _) in pairs]
    in_range = program.innermost(mids, program.ranges(events))
    for ((_, e0), (s1, _)), mid, rng in zip(pairs, mids, in_range):
        label = rng or "host (no traced call)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] += (s1 - e0) * 1e-9
    return dict(
        window_s=wall_s, busy_s=busy_s, launches=len(kernels),
        sync_calls=syncs, d2h_copies=d2h,
        kernel_s={n: v for n, v in by_kernel.items()},
        device_ops=sorted(((n, sum(v)) for n, v in by_kernel.items()),
                          key=lambda x: -x[1])[:10],
        idle_gaps=gaps.most_common(10),
        idle_by_range=program.attribute(events))
