"""Both server entry points of the port, started as a user starts them.

    python scripts/serve_smoke.py                  # the engine on the card
    python scripts/serve_smoke.py --device cpu     # on the CPU (minutes)

Writes the first ``--frames`` frames of chip_smoke.py's bench scene
(640x480, seed 11) as a P6 sequence, and a calibration file with its
camera (fx = fy = 520), to a temporary directory. Then:

1. ``python -m send_slam_tpu_torch.server.app --video DIR/%06d.ppm
   --device D`` on its default ports (4000 and 5000), the calibration
   read through ``SEND_SLAM_CALIBRATION_FILE``: ``ws://127.0.0.1:4000/
   client`` is read until an OK pose arrives, ``/metrics`` must count
   frames, then the server is interrupted (SIGINT) and must exit 0;
2. ``python -m send_slam_tpu_torch.server.backend_client --port P
   --device D`` dials the reference host played here on a free port P:
   the calibration packet, the frames as P6, ``terminate``. Pose packets
   must come back, and the backend must exit 0 after its shutdown
   printout and the keyframe trajectory file.

Prints one JSON line with what each step saw; exits non-zero on a
failure. Imports nothing of JAX, ``msgpack``, ``aiohttp`` or ``cv2``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (its WebSocket and HTTP clients)
from send_slam_tpu_torch.io import protocol  # noqa: E402
from send_slam_tpu_torch.io.ppm import encode_ppm  # noqa: E402
from send_slam_tpu_torch.utils.synth import SyntheticWorld  # noqa: E402


def write_inputs(tmp: str, n: int):
    world = SyntheticWorld(n_points=900, width=640, height=480, fx=520.0,
                           fy=520.0, seed=11)
    ts, Rs, tls = world.trajectory(n_frames=max(n, 2))
    frames = [np.round(world.render(Rs[k], tls[k])).astype(np.uint8)
              for k in range(n)]
    for k, f in enumerate(frames):
        with open(os.path.join(tmp, f"{k:06d}.ppm"), "wb") as fh:
            fh.write(encode_ppm(np.repeat(f[..., None], 3, axis=2)))
    K = [[520.0, 0.0, 320.0], [0.0, 520.0, 240.0], [0.0, 0.0, 1.0]]
    with open(os.path.join(tmp, "calibration.json"), "w") as fh:
        json.dump({"camera_matrix": {"shape": [3, 3],
                                     "data": sum(K, [])},
                   "distortion_coeffs": {"shape": [1, 5], "data": [0.0] * 5},
                   "reprojection_error": 0.0, "successful_frames": 0}, fh)
    return frames, ts


def child_env(tmp: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["SEND_SLAM_CALIBRATION_FILE"] = os.path.join(tmp, "calibration.json")
    env["SLAM_KF_TRAJECTORY_PATH"] = os.path.join(tmp, "kf.txt")
    env.pop("SLAM_SKIP_WARMUP", None)
    return env


async def app_step(tmp: str, device: str, timeout: float) -> dict:
    log_path = os.path.join(tmp, "app.log")
    with open(log_path, "w") as log:      # a file: a full pipe would stall it
        proc = subprocess.Popen(
            [sys.executable, "-m", "send_slam_tpu_torch.server.app",
             "--video", os.path.join(tmp, "%06d.ppm"), "--device", device],
            cwd=tmp, env=child_env(tmp), stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    try:
        ws = None
        while ws is None:
            if proc.poll() is not None or time.perf_counter() - t0 > timeout:
                raise RuntimeError("the application did not start")
            try:
                ws = await chip_smoke.WsClient.connect(4000, "/client")
            except OSError:
                await asyncio.sleep(0.5)
        t_ws = time.perf_counter() - t0
        while True:
            d = json.loads(await asyncio.wait_for(ws.recv_text(), timeout))
            if d["payload"]["tracking_state"] == 2:
                break
        t_pose = time.perf_counter() - t0
        await ws.close()
        status, body = await chip_smoke.http_get(4000, "/metrics")
        metrics = json.loads(body)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    with open(log_path) as log:
        out = log.read()
    return dict(rc=proc.returncode, s_to_websocket=t_ws,
                s_to_first_ok_pose=t_pose, metrics_status=status,
                metrics_frames=metrics.get("frames"),
                metrics_tracked=metrics.get("tracked"),
                log_tail=out[-600:])


async def backend_step(tmp: str, device: str, frames, ts,
                       timeout: float) -> dict:
    poses = []
    done = asyncio.Event()

    async def host(reader, writer):
        writer.write(protocol.frame_packet_bytes(
            protocol.build_calibration_packet(0, 0.0, 640, 480, 520.0, 520.0,
                                              320.0, 240.0)))
        for k, f in enumerate(frames):
            writer.write(protocol.frame_packet_bytes(
                protocol.build_frame_packet(
                    0, float(ts[k]), 640, 480,
                    encode_ppm(np.repeat(f[..., None], 3, axis=2)))))
            await writer.drain()
        writer.write(protocol.frame_packet_bytes(
            protocol.build_terminate_packet()))
        await writer.drain()
        dec = protocol.PacketDecoder()
        while data := await reader.read(1 << 16):
            poses.extend(dec.feed(data))
        writer.close()
        done.set()

    server = await asyncio.start_server(host, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "send_slam_tpu_torch.server.backend_client",
        "--port", str(port), "--device", device, cwd=tmp,
        env=child_env(tmp), stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT)
    try:
        out, _ = await asyncio.wait_for(proc.communicate(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        out, _ = await proc.communicate()
    await asyncio.wait_for(done.wait(), 10)
    server.close()
    await server.wait_closed()
    text = out.decode(errors="replace")
    kf_lines = 0
    if os.path.exists(os.path.join(tmp, "kf.txt")):
        with open(os.path.join(tmp, "kf.txt")) as fh:
            kf_lines = len(fh.read().splitlines())
    return dict(rc=proc.returncode, seconds=time.perf_counter() - t0,
                pose_packets=len(poses),
                ok_poses=sum(p.get("tracking_state") == 2 for p in poses),
                report=[ln for ln in text.splitlines() if ln.startswith((
                    "Frames processed", "median tracking", "mean tracking"))],
                kf_lines=kf_lines, log_tail=text[-600:])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--timeout", type=float, default=300.0)
    args = p.parse_args()
    with tempfile.TemporaryDirectory(prefix="serve_smoke_") as tmp:
        frames, ts = write_inputs(tmp, args.frames)
        app = asyncio.run(app_step(tmp, args.device, args.timeout))
        backend = asyncio.run(backend_step(tmp, args.device, frames, ts,
                                           args.timeout))
    print(json.dumps(dict(device=args.device, frames=args.frames, app=app,
                          backend=backend)), flush=True)
    ok = (app["rc"] == 0 and app["metrics_status"] == 200
          and (app["metrics_frames"] or 0) > 0 and backend["rc"] == 0
          and backend["ok_poses"] > 0
          and backend["ok_poses"] == backend["pose_packets"]
          and f"Frames processed: {args.frames}" in backend["report"]
          and backend["kf_lines"] >= 2)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
