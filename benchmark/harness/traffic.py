"""The one traffic generator: a synthetic world and a closed lap, rendered
through the configuration's camera and replayed for as long as the
window lasts.

A traffic file (``traffic/<name>.json``) gives the world (its size and
the seed of its geometry), the lap's length and frame rate, the frame a
session starts at and the path's scale; the configuration gives the
camera (intrinsics, distortion, image size). The frames are one fixed
recording, as a dataset's are: the session's init is chaotic (a seed
that moved the points, or dealt their looks out otherwise, changed the
frame at which it commits and with it every end-to-end number), so the
run's seed does not change them; it draws the sample of calls the
comparison checks. Frame k of a session is the lap's frame
(start_frame + k) mod lap_frames, stamped k / fps seconds.
"""

from __future__ import annotations

import io
import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np

from harness.world import SyntheticWorld, lap_poses

DIST_KEYS = ("k1", "k2", "p1", "p2", "k3")


class Traffic(NamedTuple):
    frames: np.ndarray     # (lap, H, W) uint8
    R: np.ndarray          # (lap, 3, 3) camera-from-world
    t: np.ndarray          # (lap, 3)
    centres: np.ndarray    # (lap, 3) true camera centres
    fps: float
    start: int             # the lap frame a session starts at

    @property
    def lap(self) -> int:
        return self.frames.shape[0]

    def index(self, k: int) -> int:
        """The lap frame of a session's k-th frame."""
        return (self.start + k) % self.lap

    def stamp(self, k: int) -> float:
        return k / self.fps


_WORLD = {}


def _init_worker(kw):
    _WORLD["w"] = SyntheticWorld(**kw["world"])
    _WORLD["cam"] = kw["cam"]


def _render(pose):
    R, t = pose
    cam = _WORLD["cam"]
    img = _WORLD["w"].render_radtan(R, t, cam["fx"], cam["fy"], cam["cx"],
                                    cam["cy"], [cam[k] for k in DIST_KEYS])
    return np.round(img).astype(np.uint8)


def generate(traffic: Dict, config: Dict, workers: int = 0) -> Traffic:
    cam = config["engine"]["camera"]
    kw = dict(cam=cam, world=dict(
        n_points=traffic["n_points"], seed=traffic["world_seed"],
        width=cam["width"], height=cam["height"], fx=cam["fx"], fy=cam["fy"]))
    R, t, centres = lap_poses(traffic["lap_frames"], traffic["path_scale"])
    jobs = list(zip(R, t))
    if workers > 0:
        frames = _render_in_processes(kw, jobs, workers)
    else:
        _init_worker(kw)
        frames = np.stack([_render(j) for j in jobs])
    return Traffic(frames=frames, R=R, t=t, centres=centres,
                   fps=float(traffic["fps"]),
                   start=int(traffic.get("start_frame", 0)))


def _render_in_processes(kw, jobs, workers: int) -> np.ndarray:
    """Render ``jobs`` in ``workers`` child processes, each handed its
    share on its standard input and answering on its standard output
    (pipes only: no shared memory, no files)."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from harness.traffic import _child; _child()"
            % str(Path(__file__).resolve().parent.parent))
    shares = [jobs[i::workers] for i in range(workers)]
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in shares]
    try:
        for p, share in zip(procs, shares):
            p.stdin.write(pickle.dumps((kw, share)))
            p.stdin.close()
        parts = [np.load(io.BytesIO(p.stdout.read())) for p in procs]
    finally:
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    out = np.empty((len(jobs),) + parts[0].shape[1:], np.uint8)
    for i, part in enumerate(parts):
        out[i::workers] = part
    return out


def _child() -> None:
    kw, share = pickle.load(sys.stdin.buffer)
    _init_worker(kw)
    buf = io.BytesIO()
    np.save(buf, np.stack([_render(j) for j in share]))
    sys.stdout.buffer.write(buf.getvalue())


def render_workers() -> int:
    return max(1, min(6, (os.cpu_count() or 2) - 2))
