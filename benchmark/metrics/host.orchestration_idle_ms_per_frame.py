"""ms a camera frame in which the device sat idle under the program's
``slam.frame``, ``slam.lagged`` or ``slam.loop`` range (innermost) in the
profiler window: the System's own code between its layers, the lagged
summary and loop closing."""

from harness.program import idle_ms_per_frame

RANGES = ("slam.frame", "slam.lagged", "slam.loop")


def read(run):
    return idle_ms_per_frame(run, RANGES)
