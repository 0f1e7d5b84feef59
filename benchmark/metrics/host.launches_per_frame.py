"""CUDA kernels launched in the profiler window, per camera frame."""


def read(run):
    t = run.trace
    return t["launches"] / t["frames"] if t and t["frames"] else None
