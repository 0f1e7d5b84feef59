"""Application wiring — the SendSlam.Application equivalent
(application.ex:11-121), as one asyncio supervisor:

- a frame producer (camera or video replay),
- the in-process engine worker (default) and/or the :5000 TCP
  compatibility listener for external backends,
- the :4000 web panel (+ /client pose stream),
- calibration persistence + rebroadcast.

Task supervision: each component runs as a supervised task that is
restarted with backoff on crash (the DynamicSupervisor one_for_one
semantics, application.ex:11-13).

CLI:
    python -m send_slam_tpu_torch.server.app --video 'seq/%06d.ppm'  # replay
    python -m send_slam_tpu_torch.server.app --camera 0      # live (OpenCV)
    python -m send_slam_tpu_torch.server.app --no-engine     # TCP only
    ... --device cpu                                # the engine on the CPU

The port's own copy of ``send_slam_tpu/server/app.py``. The engine runs
on ``device`` (default the card; raises without one unless given
``device="cpu"``), which ``--device`` sets in place of the JAX module's
``JAX_PLATFORMS`` handling; ``/panel`` uploads are calibrated there
too.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import List, Optional

from send_slam_tpu_torch.config import CameraConfig, EngineConfig
from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.server.bus import Bus
from send_slam_tpu_torch.server.engine_worker import EngineWorker
from send_slam_tpu_torch.server.producers import (
    CameraProducer, VideoProducer,
)
from send_slam_tpu_torch.server.tcp import TcpFrameServer
from send_slam_tpu_torch.server.web import WebPanel

log = logging.getLogger(__name__)


async def supervise(name: str, factory, backoff: float = 1.0) -> None:
    """Restart-on-crash wrapper (one_for_one supervision)."""
    while True:
        try:
            await factory()
            return
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("%s crashed; restarting in %.1fs", name, backoff)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 30.0)


class Application:
    def __init__(self, config: Optional[EngineConfig] = None,
                 video: Optional[str] = None,
                 camera_index: Optional[int] = None,
                 run_engine: bool = True,
                 run_tcp: bool = True,
                 run_web: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.config = config or self._config_with_saved_calibration()
        self.bus = Bus()
        self.video = video
        self.camera_index = camera_index
        self.run_engine = run_engine
        self.run_tcp = run_tcp
        self.run_web = run_web
        self.engine: Optional[EngineWorker] = None
        self.tcp: Optional[TcpFrameServer] = None
        self.web: Optional[WebPanel] = None
        self._tasks: List[asyncio.Task] = []

    @staticmethod
    def _config_with_saved_calibration() -> EngineConfig:
        """Load priv/calibration/latest.json if present, like the
        producers do at init (camera_producer.ex:245-279)."""
        from send_slam_tpu_torch.calib.io import (
            default_output_path, load_from_file,
        )
        cfg = EngineConfig()
        path = default_output_path()
        if os.path.exists(path):
            try:
                calib = load_from_file(path)
                K = calib["camera_matrix"]
                d = list(calib["distortion_coeffs"].reshape(-1)) + [0.0] * 5
                cfg = cfg.replace(camera=CameraConfig(
                    width=cfg.camera.width, height=cfg.camera.height,
                    fx=float(K[0][0]), fy=float(K[1][1]),
                    cx=float(K[0][2]), cy=float(K[1][2]),
                    k1=float(d[0]), k2=float(d[1]), p1=float(d[2]),
                    p2=float(d[3]), k3=float(d[4])))
                log.info("loaded calibration from %s", path)
            except Exception:
                log.exception("failed to load calibration %s", path)
        return cfg

    async def start(self) -> None:
        if self.run_web:
            self.web = WebPanel(
                self.bus, port=self.config.server.http_port,
                metrics_fn=lambda: (self.engine.stats()
                                    if self.engine else {}),
                device=self.device)
            await self.web.start()
        if self.run_tcp:
            self.tcp = TcpFrameServer(self.bus,
                                      host=self.config.server.host,
                                      port=self.config.server.tcp_port)
            await self.tcp.start()
        if self.config.server.pose_port:
            from send_slam_tpu_torch.server.pose_server import PoseServer
            self.pose_server = PoseServer(
                self.bus, port=self.config.server.pose_port)
            await self.pose_server.start()
        else:
            self.pose_server = None
        if self.run_engine:
            self.engine = EngineWorker(self.bus, self.config,
                                       device=self.device)
            self._tasks.append(asyncio.create_task(
                supervise("engine", self.engine.run)))
        if self.video:
            prod = VideoProducer(self.bus, self.video,
                                 fps=self.config.camera.fps)
            self._tasks.append(asyncio.create_task(
                supervise("video-producer", prod.run)))
        elif self.camera_index is not None:
            prod = CameraProducer(
                self.bus, self.camera_index,
                width=self.config.camera.width,
                height=self.config.camera.height,
                fps=self.config.camera.fps)
            self._tasks.append(asyncio.create_task(
                supervise("camera-producer", prod.run)))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self.tcp:
            await self.tcp.stop()
        if getattr(self, "pose_server", None):
            await self.pose_server.stop()
        if self.web:
            await self.web.stop()
        if self.engine:
            log.info("engine stats: %s", self.engine.stats())


async def _amain(args) -> None:
    app = Application(video=args.video, camera_index=args.camera,
                      run_engine=not args.no_engine, device=args.device)
    await app.start()
    try:
        await asyncio.Event().wait()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await app.stop()


def main() -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video", help="video file / image-seq pattern / dir")
    p.add_argument("--camera", type=int, default=None,
                   help="camera device index")
    p.add_argument("--no-engine", action="store_true",
                   help="disable in-process engine (external backend only)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda, or cpu)")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:       # Ctrl-C: the application has stopped
        pass


if __name__ == "__main__":
    main()
