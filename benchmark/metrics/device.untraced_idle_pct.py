"""The share (%) of the device's idle time in the profiler window that no
``slam.*`` range of the program covers: the harness's own loop, or code
the program's spans miss."""

from harness.program import UNTRACED


def read(run):
    idle = run.trace.get("idle_by_range") if run.trace else None
    total = sum(idle.values()) if idle else 0.0
    return 100.0 * idle[UNTRACED] / total if total > 0 else None
