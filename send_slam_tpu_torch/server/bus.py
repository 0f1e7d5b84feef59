"""In-process pub/sub message bus.

The asyncio equivalent of the reference's five duplicate-key Registries
(application.ex:15-44): named topics, many subscribers each, non-
blocking broadcast with per-subscriber bounded queues (slow consumers
drop oldest — a camera pipeline must never backpressure the producer,
matching Registry.dispatch fire-and-forget semantics).

The port's own copy of ``send_slam_tpu/server/bus.py``.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict
from typing import Any, AsyncIterator, Dict, Set

# Topic names mirroring the reference registries.
CAMERA = "camera"              # SendSlam.CameraRegistry
POSE = "pose"                  # SendSlam.PoseRegistry
CALIBRATION = "calibration"    # SendSlam.CalibrationRegistry
BACKEND = "backend"            # SendSlam.BackendRegistry
WEBSOCKET = "websocket"        # SendSlam.WebSocketRegistry


class Bus:
    def __init__(self, maxsize: int = 4):
        self._subs: Dict[str, Set[asyncio.Queue]] = defaultdict(set)
        self._maxsize = maxsize

    def publish(self, topic: str, msg: Any) -> None:
        for q in list(self._subs.get(topic, ())):
            if q.full():
                try:
                    q.get_nowait()      # drop oldest
                except asyncio.QueueEmpty:
                    pass
            try:
                q.put_nowait(msg)
            except asyncio.QueueFull:
                pass

    def subscribe(self, topic: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(self._maxsize)
        self._subs[topic].add(q)
        return q

    def unsubscribe(self, topic: str, q: asyncio.Queue) -> None:
        self._subs.get(topic, set()).discard(q)

    async def stream(self, topic: str) -> AsyncIterator[Any]:
        q = self.subscribe(topic)
        try:
            while True:
                yield await q.get()
        finally:
            self.unsubscribe(topic, q)
