"""The share (%) of the profiler window's wall time in which nothing ran
on the device: 100 x (1 - union of device intervals / window)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
