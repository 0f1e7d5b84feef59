"""ms a camera frame in which the device sat idle under the program's
``slam.tracking`` range (innermost) in the profiler window: the host's
work in ``track_frame`` that the device waited on."""

from harness.program import idle_ms_per_frame

RANGES = ("slam.tracking",)


def read(run):
    return idle_ms_per_frame(run, RANGES)
