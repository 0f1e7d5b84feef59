"""HTTP + WebSocket server on :4000.

The reference contract (web_server.ex:7-29):
- ``GET /``        -> panel HTML page
- ``GET /client``  -> WS: {"type": "pose", "payload": {...}} JSON per
                      pose (client_application_server.ex:16-19)
- ``GET /metrics`` -> the engine's stats as JSON

The port's own copy of ``send_slam_tpu/server/web.py``, served by the
port's ``server/http.py`` in place of ``aiohttp``; ``/client`` sends the
JAX module's JSON text for the same poses. ``GET /panel`` (binary JPEG
frames down, the calibration upload up) is not served yet: it needs the
calibration pipeline (``calib/checkerboard.py``, ``calib/zhang.py``) and
a JPEG encoder, which wait for the calibration slice of the port.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Optional

from send_slam_tpu_torch.io.protocol import pose_ws_json
from send_slam_tpu_torch.server import bus as topics
from send_slam_tpu_torch.server.bus import Bus
from send_slam_tpu_torch.server.http import (
    HttpServer, Request, Response, file_response, json_response,
)

log = logging.getLogger(__name__)

WEB_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "web")


async def serve_pose_stream(http: HttpServer, bus: Bus, request: Request
                            ) -> Optional[Response]:
    """A WebSocket sending ``pose_ws_json`` of every POSE packet as
    JSON text until the client leaves; inbound messages are ignored
    (client_application_server.ex:26-28)."""
    if not request.is_websocket:
        return Response(400, b"400: Bad Request (WebSocket expected)")
    ws = await http.upgrade(request)
    q = bus.subscribe(topics.POSE)

    async def push_poses():
        while True:
            pose = await q.get()
            await ws.send_str(json.dumps(pose_ws_json(pose)))

    pusher = asyncio.create_task(push_poses())
    try:
        async for _ in ws:
            pass
    finally:
        pusher.cancel()
        bus.unsubscribe(topics.POSE, q)
    return None


class WebPanel:
    def __init__(self, bus: Bus, host: str = "0.0.0.0", port: int = 4000,
                 metrics_fn=None):
        self.bus = bus
        self.host = host
        self.port = port
        self.metrics_fn = metrics_fn
        self.http = HttpServer(host, port)
        self.http.add_get("/", self.index)
        self.http.add_get("/client", self.client_ws)
        self.http.add_get("/metrics", self.metrics)

    async def start(self) -> None:
        await self.http.start()
        log.info("web panel on http://%s:%d", self.host, self.bound_port)

    async def stop(self) -> None:
        await self.http.stop()

    @property
    def bound_port(self) -> int:
        return self.http.bound_port

    # ------------------------------------------------------------------

    async def index(self, request: Request) -> Response:
        path = os.path.join(WEB_DIR, "index.html")
        if os.path.exists(path):
            return file_response(path)
        return Response(404, b"panel page missing")

    async def metrics(self, request: Request) -> Response:
        """Engine observability (frames/sec, per-stage timings, map
        size) as JSON — the structured version of the reference's
        scattered Logger lines (SURVEY.md §5)."""
        data = self.metrics_fn() if self.metrics_fn else {}
        return json_response(data)

    async def client_ws(self, request: Request) -> Optional[Response]:
        return await serve_pose_stream(self.http, self.bus, request)
