"""The SEND-SLAM wire protocol: 4-byte big-endian length-prefixed
MessagePack packets.

The port's own copy of ``send_slam_tpu/io/protocol.py``, packing and
unpacking with ``io/msgpack_codec.py`` in place of the ``msgpack``
package (absent on the card's machine); the bytes are the same.

This is the byte-level compatibility contract between the reference's
Elixir host and its C++ backend; a backend binary or client speaking
this protocol interoperates with us unchanged.

Packet schemas (reference cites):
- ``frame``        host -> backend: image_logger.ex:68-84
  {type, camera_id, encoding:"ppm", timestamp, width, height, channels,
   frame: <binary>}
- ``calibration``  host -> backend: image_logger.ex:86-150
  {type:"calibration", camera: {type:"PinHole", width, height, fps, rgb,
   fx, fy, cx, cy, k1, k2, p1, p2, k3, th_depth, baseline,
   depth_map_factor}, timestamp, camera_id}
- ``pose``         backend -> host: orbslam3_mono_networked.cc:225-282
  {type:"pose", timestamp, camera_id, tracking_state,
   position:{x,y,z}, orientation:{x,y,z,w}}
- ``terminate`` / ``shutdown``: orbslam3_mono_networked.cc:471-475
  {type:"terminate"}

Framing: 4-byte big-endian unsigned length, then that many MessagePack
bytes (slam_handler.ex:114-123 inbound, image_logger.ex:207-209
outbound, C++ readExact …cc:390-412 with a 50 MB guard).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

from send_slam_tpu_torch.io import msgpack_codec

MAX_PACKET_BYTES = 50 * 1024 * 1024  # …cc:404 guard: reject > 50 MB


# ---------------------------------------------------------------------------
# Framing


def frame_packet_bytes(payload: Dict[str, Any]) -> bytes:
    """Encode payload -> length-prefixed MessagePack bytes."""
    body = msgpack_codec.packb(payload)
    if len(body) > MAX_PACKET_BYTES:
        raise ValueError(f"packet too large: {len(body)} bytes")
    return struct.pack(">I", len(body)) + body


class PacketDecoder:
    """Incremental decoder for a length-prefixed MessagePack stream.

    Mirrors SlamHandler.extract_packets (slam_handler.ex:114-123):
    feed arbitrary byte chunks, iterate complete packets.
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Dict[str, Any]]:
        self._buf.extend(data)
        out: List[Dict[str, Any]] = []
        while True:
            pkt = self._try_pop()
            if pkt is None:
                return out
            out.append(pkt)

    def _try_pop(self) -> Optional[Dict[str, Any]]:
        if len(self._buf) < 4:
            return None
        (length,) = struct.unpack(">I", bytes(self._buf[:4]))
        if length > MAX_PACKET_BYTES:
            raise ValueError(f"packet length {length} exceeds 50 MB guard")
        if len(self._buf) < 4 + length:
            return None
        body = bytes(self._buf[4:4 + length])
        del self._buf[:4 + length]
        return msgpack_codec.unpackb(body)


# ---------------------------------------------------------------------------
# Packet constructors (schemas above)


def build_frame_packet(
    camera_id: int,
    timestamp: float,
    width: int,
    height: int,
    frame: bytes,
    channels: int = 3,
    encoding: str = "ppm",
) -> Dict[str, Any]:
    return {
        "type": "frame",
        "camera_id": camera_id,
        "encoding": encoding,
        "timestamp": float(timestamp),
        "width": int(width),
        "height": int(height),
        "channels": int(channels),
        "frame": frame,
    }


def build_calibration_packet(
    camera_id: int,
    timestamp: float,
    width: int,
    height: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    k1: float = 0.0,
    k2: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    k3: float = 0.0,
    fps: float = 30.0,
    rgb: int = 1,
) -> Dict[str, Any]:
    """The defaults th_depth=40.0, baseline=0.0, depth_map_factor=1000.0
    match image_logger.ex:129-146 (mono pinhole)."""
    return {
        "type": "calibration",
        "camera_id": int(camera_id),
        "timestamp": float(timestamp),
        "camera": {
            "type": "PinHole",
            "width": int(width),
            "height": int(height),
            "fps": float(fps),
            "rgb": int(rgb),
            "fx": float(fx),
            "fy": float(fy),
            "cx": float(cx),
            "cy": float(cy),
            "k1": float(k1),
            "k2": float(k2),
            "p1": float(p1),
            "p2": float(p2),
            "k3": float(k3),
            "th_depth": 40.0,
            "baseline": 0.0,
            "depth_map_factor": 1000.0,
        },
    }


def build_pose_packet(
    timestamp: float,
    camera_id: int,
    tracking_state: int,
    position,
    orientation,
) -> Dict[str, Any]:
    """position: (x,y,z) of Twc; orientation: unit quaternion (x,y,z,w)
    — layout from orbslam3_mono_networked.cc:236-264."""
    px, py, pz = (float(v) for v in position)
    qx, qy, qz, qw = (float(v) for v in orientation)
    return {
        "type": "pose",
        "timestamp": float(timestamp),
        "camera_id": int(camera_id),
        "tracking_state": int(tracking_state),
        "position": {"x": px, "y": py, "z": pz},
        "orientation": {"x": qx, "y": qy, "z": qz, "w": qw},
    }


def build_terminate_packet() -> Dict[str, Any]:
    return {"type": "terminate"}


def pose_ws_json(pose_packet: Dict[str, Any]) -> Dict[str, Any]:
    """The /client WebSocket JSON wrapper
    (client_application_server.ex:16-19):
    {"type": "pose", "payload": <pose packet>}"""
    return {"type": "pose", "payload": pose_packet}


# Tracking states mirroring ORB_SLAM3::Tracking::eTrackingState
# (state OK==2 checked at …cc:596).
TRACKING_SYSTEM_NOT_READY = -1
TRACKING_NO_IMAGES_YET = 0
TRACKING_NOT_INITIALIZED = 1
TRACKING_OK = 2
TRACKING_RECENTLY_LOST = 3
TRACKING_LOST = 4
