"""ms a camera frame in which the device sat idle under the program's
``slam.mapping`` or ``slam.polish`` range (innermost) in the profiler
window: keyframe insertion, its adjustments and the queued slices."""

from harness.program import idle_ms_per_frame

RANGES = ("slam.mapping", "slam.polish")


def read(run):
    return idle_ms_per_frame(run, RANGES)
