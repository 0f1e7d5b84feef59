"""One camera: ``System(cfg).track_monocular(frame, ts)``, closed loop.

Its recording is the lap of ``harness/traffic.py``. Set-up builds the
System and runs its ``warmup`` (every device step the session can reach,
on dummy inputs at the configured shapes; it ends in a reset). The
session starts at the window's first frame. A call hands over the next
frame of the lap and returns with the call's output on the host; it has
a pose when the output carries a live pose or backfilled ones.
"""

from __future__ import annotations

import numpy as np

from harness.traffic import generate  # noqa: F401  (the driver's recording)
from send_slam_tpu_torch.models.system import TRACKING_OK, System

# The comparison's sites and the span targets that this path adds to a
# check's and a span's own: none, the System looks every stage up where
# the checks and the spans name it.
SITES = {}
SPANS = {}


class Driver:
    def __init__(self, engine_cfg, traffic, device):
        self.cfg = engine_cfg
        self.traffic = traffic
        self.device = device
        self.k = 0
        self.system = None

    def setup(self) -> None:
        self.system = System(self.cfg, device=self.device)
        self.system.warmup()

    def step(self):
        """Hand over the next frame: (camera frames handed over, whether
        this call returned a pose)."""
        tr = self.traffic
        out = self.system.track_monocular(tr.frames[tr.index(self.k)],
                                          tr.stamp(self.k))
        self.k += 1
        return 1, bool((out.tracking_state == TRACKING_OK
                        and out.position is not None) or out.backfill)

    def images(self, k: int):
        """The images the k-th call handed over."""
        return [self.traffic.frames[self.traffic.index(k)]]

    def finish(self) -> dict:
        """The map's fill at the window's close, then the session drained:
        its one lane, the streamed trajectory as (session frame, position)
        pairs and the true camera centre of each."""
        m = self.system.map
        fill = dict(landmarks=int(m.n_landmarks()),
                    keyframes=int(m.kf_valid.sum()))
        self.system.shutdown()
        traj = {}
        for ts, pos, _q in self.system.trajectory():
            traj[int(round(ts * self.traffic.fps))] = np.asarray(pos)
        traj = sorted(traj.items())
        tr = self.traffic
        return dict(fill, lanes=[dict(
            trajectory=traj,
            centres=[tr.centres[tr.index(k)] for k, _ in traj])])
