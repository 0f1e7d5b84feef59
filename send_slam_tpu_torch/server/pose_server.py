"""Stand-alone pose-only WebSocket server.

Parity with SendSlam.PoseWebServer (pose_web_server.ex:11-14, port
4001, ``GET /ws`` — present but disabled in the reference,
application.ex:111-115): a minimal endpoint for consumers that only
want the pose stream without the panel.

The port's own copy of ``send_slam_tpu/server/pose_server.py``, on the
port's ``server/http.py`` in place of ``aiohttp``."""

from __future__ import annotations

import logging
from typing import Optional

from send_slam_tpu_torch.server.bus import Bus
from send_slam_tpu_torch.server.http import HttpServer, Request, Response
from send_slam_tpu_torch.server.web import serve_pose_stream

log = logging.getLogger(__name__)


class PoseServer:
    def __init__(self, bus: Bus, host: str = "0.0.0.0", port: int = 4001):
        self.bus = bus
        self.host = host
        self.port = port
        self.http = HttpServer(host, port)
        self.http.add_get("/ws", self.ws)

    async def start(self) -> None:
        await self.http.start()
        log.info("pose server on ws://%s:%d/ws", self.host, self.bound_port)

    async def stop(self) -> None:
        await self.http.stop()

    @property
    def bound_port(self) -> int:
        return self.http.bound_port

    async def ws(self, request: Request) -> Optional[Response]:
        return await serve_pose_stream(self.http, self.bus, request)
