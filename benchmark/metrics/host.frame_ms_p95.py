"""95th percentile over every call of the traced run's window (init,
keyframe and backfill frames included) of the ms from handing the frame
over to the call's output on the host."""

import numpy as np


def read(run):
    ms = [(e - s) * 1e3 for s, e in run.calls]
    return float(np.percentile(ms, 95)) if ms else None
