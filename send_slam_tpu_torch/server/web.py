"""HTTP + WebSocket server on :4000.

The reference contract (web_server.ex:7-29):
- ``GET /``        -> panel HTML page
- ``GET /panel``   -> WS: binary JPEG frames down; JSON
                      {"calibrationFrames": [b64...]} up, replied with
                      "OK"/"ERROR" (web_socket_handler.ex:25-52)
- ``GET /client``  -> WS: {"type": "pose", "payload": {...}} JSON per
                      pose (client_application_server.ex:16-19)
- ``GET /metrics`` -> the engine's stats as JSON

The port's own copy of ``send_slam_tpu/server/web.py``, served by the
port's ``server/http.py`` in place of ``aiohttp``; ``/client`` sends the
JAX module's JSON text for the same poses, and ``/panel`` codes JPEG
with the port's ``io/jpeg.py`` in place of ``cv2`` and calibrates with
the port's ``calib/`` on the panel's device.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
import logging
import os
from typing import Optional

import numpy as np

from send_slam_tpu_torch.io.jpeg import decode_jpeg_gray, encode_jpeg
from send_slam_tpu_torch.io.protocol import pose_ws_json
from send_slam_tpu_torch.server import bus as topics
from send_slam_tpu_torch.server.bus import Bus
from send_slam_tpu_torch.server.http import (
    OP_TEXT, HttpServer, Request, Response, file_response, json_response,
)
from send_slam_tpu_torch.server.producers import FrameEvent

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


def decode_calibration_frames(frames_b64) -> list:
    """The upload's base64 data URLs (the part after the last comma) as
    float32 gray images; entries that do not decode are skipped."""
    frames = []
    for b64 in frames_b64:
        try:
            raw = base64.b64decode(b64.split(",")[-1])
            frames.append(decode_jpeg_gray(raw).astype(np.float32))
        except (AttributeError, binascii.Error, ValueError):
            continue
    return frames


class WebPanel:
    """``device``: where ``/panel`` uploads are calibrated (default the
    card)."""

    def __init__(self, bus: Bus, host: str = "0.0.0.0", port: int = 4000,
                 metrics_fn=None, device=None):
        self.bus = bus
        self.host = host
        self.port = port
        self.metrics_fn = metrics_fn
        self.device = device
        self.http = HttpServer(host, port)
        self.http.add_get("/", self.index)
        self.http.add_get("/panel", self.panel_ws)
        self.http.add_get("/client", self.client_ws)
        self.http.add_get("/metrics", self.metrics)
        self.frames_sent = 0

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

    async def panel_ws(self, request: Request) -> Optional[Response]:
        """A JPEG of every CAMERA frame down as a binary message; a text
        message up is JSON, answered "ERROR" when malformed, and its
        ``calibrationFrames`` run a calibration answered "OK" or
        "ERROR"."""
        if not request.is_websocket:
            return Response(400, b"400: Bad Request (WebSocket expected)")
        ws = await self.http.upgrade(request)
        q = self.bus.subscribe(topics.CAMERA)

        async def push_frames():
            while True:
                ev: FrameEvent = await q.get()
                await ws.send_bytes(encode_jpeg(ev.frame))
                self.frames_sent += 1

        pusher = asyncio.create_task(push_frames())
        try:
            async for op, data in ws:
                if op != OP_TEXT:
                    continue
                try:
                    payload = json.loads(data)
                except (UnicodeDecodeError, json.JSONDecodeError):
                    await ws.send_str("ERROR")
                    continue
                frames_b64 = (payload.get("calibrationFrames")
                              if isinstance(payload, dict) else None)
                if frames_b64:
                    reply = await self._run_calibration(frames_b64)
                    await ws.send_str(reply)
        finally:
            pusher.cancel()
            self.bus.unsubscribe(topics.CAMERA, q)
        return None

    async def _run_calibration(self, frames_b64) -> str:
        """Decode browser-captured frames, calibrate, persist, broadcast
        (web_socket_handler.ex:25-52)."""
        from send_slam_tpu_torch.calib.io import save_to_file
        from send_slam_tpu_torch.calib.pipeline import calibrate

        frames = decode_calibration_frames(frames_b64)
        try:
            loop = asyncio.get_running_loop()
            result = await loop.run_in_executor(
                None, lambda: calibrate(frames, device=self.device))
        except Exception as e:
            log.warning("calibration failed: %s", e)
            return "ERROR"
        save_to_file(result)
        self.bus.publish(topics.CALIBRATION, result)
        return "OK"

    async def client_ws(self, request: Request) -> Optional[Response]:
        return await serve_pose_stream(self.http, self.bus, request)
