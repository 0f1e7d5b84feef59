"""The FAST kernel's share of its roofline (%): the least time the card
could take on the frames the profiler window served (harness/peaks.py,
NVIDIA's published H100 peaks) over the kernel's mean device time per
launch in that window."""

KERNEL = "fast_levels_kernel"


def read(run):
    t = run.trace
    if not t or run.fast_bound_ms is None:
        return None
    times = [s for name, v in t["kernel_s"].items() if KERNEL in name
             for s in v]
    if not times:
        return None
    return 100.0 * run.fast_bound_ms / (sum(times) / len(times) * 1e3)
