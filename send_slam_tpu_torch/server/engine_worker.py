"""In-process SLAM engine worker: frames in, poses out.

This replaces the reference's whole frame->TCP->docker->TCP->pose loop
(SURVEY.md §3.2) with a direct library call: CAMERA bus events are
grayscale-converted, tracked by models.system.System in a worker thread
(the engine's host work must not block the event loop), and resulting
poses are published on the POSE topic as reference-format pose packets
(orbslam3_mono_networked.cc:225-282).

The port's own copy of ``send_slam_tpu/server/engine_worker.py``: the
System runs on ``device`` (default the card; raises without one unless
given ``device="cpu"``).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import numpy as np

from send_slam_tpu_torch.config import EngineConfig
from send_slam_tpu_torch.io.native import rgb_to_gray as rgb_to_gray_u8
from send_slam_tpu_torch.io.protocol import TRACKING_OK, build_pose_packet
from send_slam_tpu_torch.models.system import System
from send_slam_tpu_torch.server import bus as topics
from send_slam_tpu_torch.server.bus import Bus
from send_slam_tpu_torch.server.producers import FrameEvent
from send_slam_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)


class EngineWorker:
    """Consumes CAMERA frames, tracks, publishes POSE packets."""

    def __init__(self, bus: Bus, config: EngineConfig, device=None):
        self.bus = bus
        self.config = config
        self.system = System(config, device=device)
        self._stop = asyncio.Event()
        self.frames_in = 0
        self.frames_tracked = 0
        self.timer = StageTimer()

    def stop(self) -> None:
        self._stop.set()

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        # Run every engine step once before the first frame (the
        # reference pays its analogous one-off cost — vocabulary load —
        # inside ORB_SLAM3::System's constructor): the kernel build,
        # library handles, allocator growth. SLAM_SKIP_WARMUP=1 skips
        # it; the costs then land on the first frames.
        if os.environ.get("SLAM_SKIP_WARMUP") != "1":
            t0 = time.perf_counter()
            await loop.run_in_executor(
                None, lambda: self.system.warmup(image_dtype=np.float32))
            log.info("engine warmup took %.1fs",
                     time.perf_counter() - t0)
        q = self.bus.subscribe(topics.CAMERA)
        try:
            while not self._stop.is_set():
                try:
                    ev: FrameEvent = await asyncio.wait_for(q.get(), 0.5)
                except asyncio.TimeoutError:
                    continue
                with self.timer.stage("gray_convert"):
                    gray = rgb_to_gray_u8(ev.frame) if ev.frame.ndim == 3 \
                        else ev.frame
                t0 = time.perf_counter()
                out = await loop.run_in_executor(
                    None, self.system.track_monocular,
                    gray.astype(np.float32), ev.timestamp)
                self.timer.add("track_monocular", time.perf_counter() - t0)
                self.frames_in += 1
                # Late-emitted poses of earlier frames (init-commit
                # backfill, collapse-probe hold flushes): published
                # with their OWN timestamps before the live pose, so
                # trajectory consumers see time order.
                for bts, bpos, bquat in out.backfill:
                    self.frames_tracked += 1
                    self.bus.publish(topics.POSE, build_pose_packet(
                        bts, ev.camera_id, TRACKING_OK, bpos, bquat))
                if out.tracking_state == TRACKING_OK:
                    self.frames_tracked += 1
                    pkt = build_pose_packet(
                        ev.timestamp, ev.camera_id, out.tracking_state,
                        out.position, out.orientation)
                    self.bus.publish(topics.POSE, pkt)
        finally:
            self.bus.unsubscribe(topics.CAMERA, q)

    def stats(self) -> dict:
        """Shutdown / metrics stats like the reference backend's
        per-frame timing printout (…cc:656-664) and the ImageTimer FPS
        counter (timer.ex:29-44)."""
        return {
            "frames": self.frames_in,
            "tracked": self.frames_tracked,
            "tracking_state": self.system.get_tracking_state(),
            "n_keyframes": int(self.system.map.n_kf),
            "n_landmarks": int(self.system.map.n_landmarks()),
            "loops_closed": self.system.loops_closed,
            "stages": self.timer.summary(),
        }
