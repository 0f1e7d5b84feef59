"""Frame producers: live camera and video/image-sequence replay.

Re-designs SendSlam.CameraProducer (camera_producer.ex) and
SendSlam.VideoProducer (video_producer.ex) as asyncio tasks publishing
``FrameEvent``s on the bus CAMERA topic. Feature parity:

- camera: V4L index open, requested size/fps, reopen-on-error
  (camera_producer.ex:72-76, 98-140);
- video: file or printf-style image-sequence patterns (``%06d``),
  loop-on-EOF, fps pacing, robust path probing
  (video_producer.ex:212-251, 313-318, 396-401, 491-508);
- both attach the latest calibration to every frame event and listen
  for calibration broadcasts (camera_producer.ex:190-208, 245-297).

OpenCV is used only here, at the ingestion edge (the reference uses
Evision the same way); the SLAM path never touches it.

The port's own copy of ``send_slam_tpu/server/producers.py``. Binary
PPM/PGM images (a printf pattern or a directory) are read with the
port's ``io/ppm.py``, as ``cv2.imread`` reads them: RGB, a PGM's gray
repeated in three channels. Other formats and the camera import ``cv2``
inside the function that needs it, as the JAX module does, and raise its
``ImportError`` where OpenCV is absent (the card's machine has none). A
directory's ``*.ppm`` and ``*.pgm`` files are replayed beside its
``*.png`` and ``*.jpg``, in one sorted order.
"""

from __future__ import annotations

import asyncio
import glob
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from send_slam_tpu_torch.io.ppm import decode_ppm
from send_slam_tpu_torch.server import bus as topics
from send_slam_tpu_torch.server.bus import Bus

log = logging.getLogger(__name__)

_PNM = (".ppm", ".pgm")


def read_image(path: str) -> Optional[np.ndarray]:
    """An image file -> (H, W, 3) RGB uint8, or None where it cannot be
    read (``cv2.imread``'s contract). PPM/PGM without OpenCV."""
    if path.lower().endswith(_PNM):
        try:
            with open(path, "rb") as f:
                img = decode_ppm(f.read())
        except (OSError, ValueError):
            return None
        return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
    import cv2
    img = cv2.imread(path)
    return None if img is None else img[..., ::-1]


@dataclass
class FrameEvent:
    frame: np.ndarray             # (H, W, 3) RGB uint8
    timestamp: float
    fps: float
    camera_id: int
    calibration: Optional[Dict[str, Any]] = None


class VideoProducer:
    """Replays a video file or an image sequence at a target fps."""

    def __init__(self, bus: Bus, path: str, fps: float = 30.0,
                 camera_id: int = 0, loop: bool = True,
                 calibration: Optional[Dict[str, Any]] = None):
        self.bus = bus
        self.path = path
        self.fps = fps
        self.camera_id = camera_id
        self.loop = loop
        self.calibration = calibration
        self._stop = asyncio.Event()

    def stop(self) -> None:
        self._stop.set()

    def _frames(self):
        if any(tok in self.path for tok in ("%d", "%0")):
            # printf-style image sequence (video_producer.ex:212-251).
            i = 0
            while True:
                p = self.path % i
                if not os.path.exists(p):
                    break
                img = read_image(p)
                if img is None:
                    break
                yield img
                i += 1
        elif os.path.isdir(self.path):
            for p in sorted(glob.glob(os.path.join(self.path, "*.png")) +
                            glob.glob(os.path.join(self.path, "*.jpg")) +
                            glob.glob(os.path.join(self.path, "*.ppm")) +
                            glob.glob(os.path.join(self.path, "*.pgm"))):
                img = read_image(p)
                if img is not None:
                    yield img
        else:
            import cv2
            cap = cv2.VideoCapture(self.path)
            try:
                while True:
                    ok, img = cap.read()
                    if not ok:
                        break
                    yield img[..., ::-1]
            finally:
                cap.release()

    async def run(self) -> None:
        interval = 1.0 / self.fps
        while not self._stop.is_set():
            t0 = time.monotonic()
            n = 0
            for img in self._frames():
                if self._stop.is_set():
                    return
                ts = time.time()
                self.bus.publish(topics.CAMERA, FrameEvent(
                    frame=np.ascontiguousarray(img), timestamp=ts,
                    fps=self.fps, camera_id=self.camera_id,
                    calibration=self.calibration))
                n += 1
                # fps pacing (video_producer.ex:396-401).
                target = t0 + n * interval
                delay = target - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                else:
                    await asyncio.sleep(0)
            if not self.loop or n == 0:
                return


class CameraProducer:
    """Live camera via OpenCV VideoCapture with reopen-on-error."""

    def __init__(self, bus: Bus, device_index: int = 0,
                 width: int = 640, height: int = 480, fps: float = 30.0,
                 camera_id: int = 0,
                 calibration: Optional[Dict[str, Any]] = None):
        self.bus = bus
        self.device_index = device_index
        self.width, self.height, self.fps = width, height, fps
        self.camera_id = camera_id
        self.calibration = calibration
        self._stop = asyncio.Event()

    def stop(self) -> None:
        self._stop.set()

    def _open(self):
        import cv2
        cap = cv2.VideoCapture(self.device_index)
        # Property setup like camera_producer.ex:106-111 (MJPG + size + fps).
        cap.set(cv2.CAP_PROP_FOURCC, cv2.VideoWriter_fourcc(*"MJPG"))
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.width)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.height)
        cap.set(cv2.CAP_PROP_FPS, self.fps)
        return cap

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stop.is_set():
            cap = self._open()
            if not cap.isOpened():
                log.warning("camera %s open failed; retrying",
                            self.device_index)
                await asyncio.sleep(1.0)
                continue
            try:
                while not self._stop.is_set():
                    ok, img = await loop.run_in_executor(None, cap.read)
                    if not ok:
                        log.warning("camera read failed; reopening")
                        break
                    self.bus.publish(topics.CAMERA, FrameEvent(
                        frame=np.ascontiguousarray(img[..., ::-1]),
                        timestamp=time.time(), fps=self.fps,
                        camera_id=self.camera_id,
                        calibration=self.calibration))
            finally:
                cap.release()
            await asyncio.sleep(0.2)
