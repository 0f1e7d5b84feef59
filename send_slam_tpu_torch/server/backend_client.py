"""Backend role: drop-in GPU replacement for the reference's dockerized
ORB-SLAM3 container.

Mirrors orbslam3_mono_networked.cc as a protocol peer: dial the host
(``ORB_SLAM3_WS_PORT``-style port config, …cc:346-370), consume
``calibration``/``frame``/``terminate`` packets, run the engine,
and send a ``pose`` packet per successfully tracked frame (Twc,
tracking_state — …cc:225-282, emitted only when tracking is OK,
…cc:595-599). A user of the reference can stop the docker container
and run ``python -m send_slam_tpu_torch.server.backend_client`` instead.

The port's own copy of ``send_slam_tpu/server/backend_client.py``: the
engine runs on the card (``--device``, default ``cuda``; without a card
it raises unless given ``--device cpu``) and sends the JAX module's
bytes for the same tracking outputs. ``_resize_gray`` keeps both
branches; on a machine without OpenCV the numpy bilinear one runs.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

import numpy as np

from send_slam_tpu_torch.config import CameraConfig, EngineConfig
from send_slam_tpu_torch.device import resolve_device
from send_slam_tpu_torch.io.ppm import rgb_to_gray_u8
from send_slam_tpu_torch.io.protocol import (
    PacketDecoder, TRACKING_OK, build_pose_packet, frame_packet_bytes,
)
from send_slam_tpu_torch.models.system import System

log = logging.getLogger(__name__)


def _decode_frame(pkt: dict) -> Optional[np.ndarray]:
    data = pkt.get("frame")
    if data is None:
        data = pkt.get("image")
    if data is None:
        return None
    enc = pkt.get("encoding", "ppm")
    if enc == "ppm":
        # Fused native decode+luma when the hostio library is built.
        from send_slam_tpu_torch.io import native
        try:
            return native.decode_ppm_gray(data)
        except ValueError:
            return None
    else:
        # JPEG/PNG fallback via cv2 (the reference backend uses
        # cv::imdecode IMREAD_UNCHANGED for the same reason, …cc:546).
        import cv2
        arr = np.frombuffer(data, np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_UNCHANGED)
        if img is None:
            return None
        if img.ndim == 3:
            img = img[..., ::-1]
    if img.ndim == 3:
        img = rgb_to_gray_u8(img)
    return img


def _image_scale(pkt: dict) -> float:
    """Image scale factor, mirroring ORB_SLAM3's Camera.imageScale /
    ``System::GetImageScale()`` that the reference adapter honors
    (…cc:512,556-580). Sources: the calibration packet's camera dict
    (``image_scale``) or the ``SLAM_IMAGE_SCALE`` env override."""
    env = os.environ.get("SLAM_IMAGE_SCALE")
    if env:
        return float(env)
    return float(pkt.get("camera", {}).get("image_scale", 1.0))


def _resize_gray(gray: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize at the ingestion edge (reference: cv::resize,
    …cc:565-567). cv2 when available, numpy bilinear fallback."""
    h, w = gray.shape
    nw, nh = int(w * scale), int(h * scale)
    try:
        import cv2
        return cv2.resize(gray, (nw, nh), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        ys = (np.arange(nh) + 0.5) / scale - 0.5
        xs = (np.arange(nw) + 0.5) / scale - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = gray.astype(np.float32)
        out = (g[y0][:, x0] * (1 - fy) * (1 - fx)
               + g[y0][:, x0 + 1] * (1 - fy) * fx
               + g[y0 + 1][:, x0] * fy * (1 - fx)
               + g[y0 + 1][:, x0 + 1] * fy * fx)
        return out.astype(gray.dtype)


def _scaled_calibration(pkt: dict) -> dict:
    """Copy of the calibration packet with image_scale already applied
    to the camera dims/intrinsics (and image_scale normalized to 1.0).

    EVERY config_factory — default or caller-supplied — receives this
    pre-scaled packet, so a factory that ignores image_scale can no
    longer end up with resized frames against unscaled geometry
    (ADVICE r4). Mirrors ORB_SLAM3's Settings, which scales intrinsics
    by imageScale internally before the system ever sees them."""
    s = _image_scale(pkt)
    if s == 1.0:
        return pkt
    cam = dict(pkt.get("camera", {}))
    for k in ("fx", "fy", "cx", "cy"):
        if k in cam:
            cam[k] = float(cam[k]) * s
    for k in ("width", "height"):
        if k in cam:
            cam[k] = int(int(cam[k]) * s)
    cam["image_scale"] = 1.0
    out = dict(pkt)
    out["camera"] = cam
    return out


def _config_from_calibration(pkt: dict) -> EngineConfig:
    cam = pkt["camera"]   # already pre-scaled by _scaled_calibration
    return EngineConfig(camera=CameraConfig(
        width=int(cam["width"]), height=int(cam["height"]),
        fx=float(cam["fx"]), fy=float(cam["fy"]),
        cx=float(cam["cx"]), cy=float(cam["cy"]),
        k1=float(cam.get("k1", 0.0)), k2=float(cam.get("k2", 0.0)),
        p1=float(cam.get("p1", 0.0)), p2=float(cam.get("p2", 0.0)),
        k3=float(cam.get("k3", 0.0)), fps=float(cam.get("fps", 30.0)),
    ))


class BackendClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5000,
                 config_factory=None, device=None):
        self.host = host
        self.port = port
        self.device = resolve_device(device)
        self.system: Optional[System] = None
        # Overridable for tests / custom capacities; default derives the
        # config from the received calibration packet.
        self._config_factory = config_factory or _config_from_calibration
        self.frames_seen = 0
        self.image_scale = 1.0
        # Per-frame tracking times, for the shutdown stats print
        # (reference vTimesTrack, …cc:618,656-667).
        self.track_times: list = []
        # Where SaveKeyFrameTrajectoryTUM lands on terminate
        # (…cc:670); None disables the dump.
        self.trajectory_path: Optional[str] = os.environ.get(
            "SLAM_KF_TRAJECTORY_PATH", "KeyFrameTrajectory.txt")

    async def run(self) -> None:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        log.info("connected to host %s:%d", self.host, self.port)
        dec = PacketDecoder()
        loop = asyncio.get_running_loop()
        try:
            await self._serve(reader, writer, dec, loop)
        except (ConnectionResetError, BrokenPipeError):
            # Host hung up — treated as shutdown, like the reference
            # backend exiting on a closed socket (…cc:636-650).
            log.info("host connection lost; shutting down")
        finally:
            writer.close()
            self._shutdown_report()

    def _shutdown_report(self) -> None:
        """The reference backend's terminate tail (…cc:653-671): sorted
        median/mean tracking time to stdout + TUM keyframe trajectory."""
        if self.system is None:
            return
        self.system.shutdown()
        if self.track_times:
            times = sorted(self.track_times)
            print("-------")
            print(f"Frames processed: {len(times)}")
            print(f"median tracking time: {times[len(times) // 2]}")
            print(f"mean tracking time: {sum(times) / len(times)}")
        else:
            print("No frames processed.")
        if self.trajectory_path:
            with open(self.trajectory_path, "w") as f:
                f.write(self.system.keyframe_trajectory_tum())
            log.info("keyframe trajectory saved to %s", self.trajectory_path)

    async def _serve(self, reader, writer, dec, loop) -> None:
        try:
            while True:
                data = await reader.read(1 << 20)
                if not data:
                    return
                for pkt in dec.feed(data):
                    ptype = pkt.get("type")
                    if ptype in ("terminate", "shutdown"):
                        log.info("terminate received")
                        return
                    if ptype == "calibration":
                        # (Re)build the engine — the reference backend
                        # reconstructs ORB_SLAM3::System the same way,
                        # discarding the old map (…cc:477-519).
                        self.system = System(
                            self._config_factory(_scaled_calibration(pkt)),
                            device=self.device)
                        self.image_scale = _image_scale(pkt)
                        self.track_times = []
                        if os.environ.get("SLAM_SKIP_WARMUP") != "1":
                            await loop.run_in_executor(
                                None, lambda: self.system.warmup(
                                    image_dtype=np.float32))
                        log.info("engine initialized from calibration "
                                 "(warmed up)")
                    elif ptype == "frame" and self.system is not None:
                        self.frames_seen += 1
                        gray = _decode_frame(pkt)
                        if gray is None:
                            continue
                        t0 = time.perf_counter()
                        if self.image_scale != 1.0:
                            gray = _resize_gray(gray, self.image_scale)
                        out = await loop.run_in_executor(
                            None, self.system.track_monocular,
                            gray.astype(np.float32),
                            float(pkt.get("timestamp", 0.0)))
                        # resize + track, like the reference's t_track
                        # (…cc:593-618 ttrack incl. the resize window).
                        self.track_times.append(time.perf_counter() - t0)
                        # Late poses (init backfill / probe-hold
                        # flush) precede the live one, timestamps
                        # their own — the reference host keys packets
                        # by timestamp, not arrival order.
                        for bts, bpos, bquat in out.backfill:
                            writer.write(frame_packet_bytes(
                                build_pose_packet(
                                    float(bts),
                                    int(pkt.get("camera_id", 0)),
                                    TRACKING_OK, bpos, bquat)))
                        if out.tracking_state == TRACKING_OK:
                            pose = build_pose_packet(
                                float(pkt.get("timestamp", 0.0)),
                                int(pkt.get("camera_id", 0)),
                                out.tracking_state, out.position,
                                out.orientation)
                            writer.write(frame_packet_bytes(pose))
                            await writer.drain()
        finally:
            writer.close()


def main() -> None:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("ORB_SLAM3_WS_PORT", "5000")))
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda, or cpu)")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(BackendClient(args.host, args.port,
                              device=args.device).run())


if __name__ == "__main__":
    main()
