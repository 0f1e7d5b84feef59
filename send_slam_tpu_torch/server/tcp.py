"""TCP host listener on :5000 — the backend compatibility port.

Re-implements ThousandIsland + SendSlam.SlamHandler (slam_handler.ex):
each connected backend gets the cached calibration packet immediately
(slam_handler.ex:330-354), then a PPM ``frame`` packet per camera frame
(:59-88) and, once per connection, a ``calibration`` packet when one is
attached (:159-187). Inbound length-prefixed packets are reassembled
(:114-123) and ``pose`` packets are broadcast on the POSE topic
(:125-137, 319-328). An unmodified reference ORB-SLAM3 container can
connect here and drive the same pose pipeline as the in-process engine.

The port's own copy of ``send_slam_tpu/server/tcp.py``; its bytes are
the JAX module's for the same frame events.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, Optional

from send_slam_tpu_torch.io.native import encode_ppm
from send_slam_tpu_torch.io.protocol import (
    PacketDecoder, build_calibration_packet, build_frame_packet,
    frame_packet_bytes,
)
from send_slam_tpu_torch.server import bus as topics
from send_slam_tpu_torch.server.bus import Bus
from send_slam_tpu_torch.server.producers import FrameEvent

log = logging.getLogger(__name__)


def calibration_packet_from_dict(calib: Dict[str, Any], camera_id: int,
                                 width: int, height: int,
                                 fps: float) -> Dict[str, Any]:
    """Reference calibration dict (camera_matrix/distortion_coeffs) ->
    wire calibration packet (image_logger.ex:124-150)."""
    K = calib["camera_matrix"]
    d = list(map(float, calib["distortion_coeffs"].reshape(-1))) + [0.0] * 5
    return build_calibration_packet(
        camera_id, time.time(), width, height,
        fx=float(K[0][0]), fy=float(K[1][1]),
        cx=float(K[0][2]), cy=float(K[1][2]),
        k1=d[0], k2=d[1], p1=d[2], p2=d[3], k3=d[4], fps=fps)


class TcpFrameServer:
    """The :5000 listener. One handler task per backend connection."""

    def __init__(self, bus: Bus, host: str = "127.0.0.1", port: int = 5000):
        self.bus = bus
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        # Latest calibration packet, replayed to new connections
        # (CalibrationCache, calibration_cache.ex:15-37).
        self.cached_calibration: Optional[Dict[str, Any]] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        log.info("backend connected: %s", peer)
        q = self.bus.subscribe(topics.CAMERA)
        sent_calibration = False

        if self.cached_calibration is not None:
            writer.write(frame_packet_bytes(self.cached_calibration))
            await writer.drain()
            sent_calibration = True

        async def pump_frames():
            nonlocal sent_calibration
            while True:
                ev: FrameEvent = await q.get()
                if not sent_calibration and ev.calibration is not None:
                    pkt = calibration_packet_from_dict(
                        ev.calibration, ev.camera_id,
                        ev.frame.shape[1], ev.frame.shape[0], ev.fps)
                    self.cached_calibration = pkt
                    writer.write(frame_packet_bytes(pkt))
                    sent_calibration = True
                data = encode_ppm(ev.frame)
                pkt = build_frame_packet(
                    ev.camera_id, ev.timestamp,
                    ev.frame.shape[1], ev.frame.shape[0], data)
                writer.write(frame_packet_bytes(pkt))
                await writer.drain()

        async def pump_poses():
            dec = PacketDecoder()
            while True:
                data = await reader.read(65536)
                if not data:
                    return
                for pkt in dec.feed(data):
                    if pkt.get("type") == "pose":
                        self.bus.publish(topics.POSE, pkt)

        tasks = [asyncio.create_task(pump_frames()),
                 asyncio.create_task(pump_poses())]
        try:
            await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in tasks:
                t.cancel()
            self.bus.unsubscribe(topics.CAMERA, q)
            writer.close()
            log.info("backend disconnected: %s", peer)
