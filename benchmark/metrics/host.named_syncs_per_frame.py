"""The program's explicit device-to-host reads in the profiler window, per
camera frame: the sum of its ``sync.<site>`` counters."""

from harness.program import SYNC


def read(run):
    t = run.trace
    if run.counters is None or not t or not t["frames"]:
        return None
    return sum(v for k, v in run.counters.items()
               if k.startswith(SYNC)) / t["frames"]
