"""One camera: ``System(cfg).track_monocular(frame, ts)``, closed loop.

Set-up builds the System and runs its ``warmup`` (every device step the
session can reach, on dummy inputs at the configured shapes; it ends in a
reset). The session starts at the window's first frame. A call hands
over the next frame of the lap and returns with the call's output on
the host; it has a pose when the output carries a live pose or
backfilled ones.
"""

from __future__ import annotations

import numpy as np

from send_slam_tpu_torch.models.system import TRACKING_OK, System


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

    def step(self) -> bool:
        """Hand over the next frame; True when this call returned a pose."""
        tr = self.traffic
        out = self.system.track_monocular(tr.frames[tr.index(self.k)],
                                          tr.stamp(self.k))
        self.k += 1
        return bool((out.tracking_state == TRACKING_OK
                     and out.position is not None) or out.backfill)

    def finish(self) -> dict:
        """The map's fill at the window's close, then the session drained:
        the streamed trajectory as (session frame, position) pairs."""
        m = self.system.map
        fill = dict(landmarks=int(m.n_landmarks()),
                    keyframes=int(m.kf_valid.sum()))
        self.system.shutdown()
        traj = {}
        for ts, pos, _q in self.system.trajectory():
            traj[int(round(ts * self.traffic.fps))] = np.asarray(pos)
        return dict(fill, trajectory=sorted(traj.items()))
