"""The port's engine-facing server paths against the JAX package's.

- A scripted System stub is patched into both packages'
  ``backend_client`` and ``engine_worker``: for the same host packets or
  frame events their outbound bytes, the images handed to the engine,
  the shutdown printout and the TUM file must be identical (backfill
  before the live pose, non-OK frames, ``image_scale`` through the numpy
  resize with ``cv2`` hidden and through ``cv2``, ``terminate``, a lost
  host). ``time.perf_counter`` is replaced by a counter in both so the
  printed times agree.
- The port's real System on the CPU at ``tests/test_backend_client.py``'s
  small configuration: the poses it serves over the wire (after its
  warmup) equal a library-path run of the same frames without a warmup,
  bit for bit; ``warmup()`` leaves a session bit-equal; and
  ``get_tracking_state``.
- The ``Application`` end to end on the CPU over a ``.ppm`` printf
  sequence, as ``tests/test_app_integration.py`` runs the JAX one.
"""

import asyncio
import itertools
import json
import sys
import time
import types
from typing import NamedTuple

import aiohttp
import numpy as np
import pytest

from send_slam_tpu.calib import io as jcalib_io
from send_slam_tpu.io import protocol as jproto
from send_slam_tpu.io.ppm import encode_ppm
from send_slam_tpu.server import app as japp
from send_slam_tpu.server import backend_client as jbc
from send_slam_tpu.server import bus as jbus
from send_slam_tpu.server import engine_worker as jew
from send_slam_tpu.server import producers as jprod
from send_slam_tpu_torch.calib import io as tcalib_io
from send_slam_tpu_torch.config import (
    CameraConfig, EngineConfig, MapConfig, OrbConfig, ServerConfig,
    TrackingConfig,
)
from send_slam_tpu_torch.io import protocol as tproto
from send_slam_tpu_torch.models.system import TRACKING_OK, System
from send_slam_tpu_torch.server import app as tapp
from send_slam_tpu_torch.server import backend_client as tbc
from send_slam_tpu_torch.server import bus as tbus
from send_slam_tpu_torch.server import engine_worker as tew
from send_slam_tpu_torch.server import producers as tprod
from send_slam_tpu_torch.utils.synth import SyntheticWorld

N_FRAMES = 20


class Out(NamedTuple):
    tracking_state: int
    position: object
    orientation: object
    n_inliers: int
    timestamp: float
    backfill: tuple = ()


def f32(*v):
    return np.asarray(v, np.float32)


# One output per track_monocular call, cycled: initializing, an OK frame
# carrying two late poses, recently lost, OK, lost.
SCRIPT = [
    lambda ts: Out(1, None, None, 0, ts),
    lambda ts: Out(2, f32(0.1, 0.2, 0.3), f32(0, 0, 0.6, 0.8), 90, ts,
                   ((ts - 0.2, f32(0.01, 0.02, 0.03), f32(0, 0, 0, 1)),
                    (ts - 0.1, f32(0.05, 0.1, 0.15), f32(0, 0.6, 0, 0.8)))),
    lambda ts: Out(3, None, None, 0, ts),
    lambda ts: Out(2, f32(1.5, -2.5, 1e-7), f32(0.5, 0.5, 0.5, 0.5), 80,
                   ts),
    lambda ts: Out(4, None, None, 0, ts),
]


class StubSystem:
    """Scripted stand-in for both packages' System."""

    made: list = []

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.images, self.warmups, self.shutdowns = [], [], 0
        self.state = 0
        self.loops_closed = 1
        self.map = types.SimpleNamespace(n_kf=np.int32(3),
                                         n_landmarks=lambda: 77)
        StubSystem.made.append(self)

    def warmup(self, image_dtype=np.uint8, block=False):
        self.warmups.append(np.dtype(image_dtype).name)

    def track_monocular(self, gray, timestamp):
        self.images.append(np.array(gray))
        out = SCRIPT[len(self.images) % len(SCRIPT) - 1](timestamp)
        self.state = out.tracking_state
        return out

    def get_tracking_state(self):
        return self.state

    def shutdown(self):
        self.shutdowns += 1
        return []

    def keyframe_trajectory_tum(self):
        return "1.000000 0.1 0.2 0.3 0 0 0 1\n2.000000 0.4 0.5 0.6 0 0 0 1\n"


@pytest.fixture
def stubbed(monkeypatch):
    for mod in (jbc, tbc, jew, tew):
        monkeypatch.setattr(mod, "System", StubSystem)
    ticks = itertools.count()       # a dyadic step: exact differences
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) / 64)
    StubSystem.made = []
    return StubSystem


def host_packets(scale, extra_png):
    rng = np.random.default_rng(5)
    calib = jproto.build_calibration_packet(3, 0.5, 64, 48, 60.0, 61.0,
                                            32.0, 24.0, k1=0.01, fps=15.0)
    if scale != 1.0:
        calib["camera"]["image_scale"] = scale
    pkts = [calib]
    for k in range(7):
        rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        pkts.append(jproto.build_frame_packet(3, 10.0 + 0.1 * k, 64, 48,
                                              encode_ppm(rgb)))
    pkts.append(jproto.build_frame_packet(3, 11.0, 64, 48, b"not a ppm"))
    gray = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    pkts.append({"type": "frame", "camera_id": 3, "timestamp": 11.1,
                 "image": encode_ppm(gray)})
    if extra_png:
        import cv2
        ok, png = cv2.imencode(".png", rng.integers(0, 256, (48, 64, 3),
                                                    dtype=np.uint8))
        pkts.append(jproto.build_frame_packet(3, 11.2, 64, 48, png.tobytes(),
                                              encoding="png"))
    return pkts


async def serve_host(client_cls, pkts, terminate, tum_path, **kw):
    """Play the reference host: send ``pkts`` (then ``terminate``, or
    hang up), return every byte the backend sent until it closed."""
    got = bytearray()
    done = asyncio.Event()

    async def host(reader, writer):
        for p in pkts:
            writer.write(jproto.frame_packet_bytes(p))
        await writer.drain()
        if terminate:
            writer.write(jproto.frame_packet_bytes(
                jproto.build_terminate_packet()))
            await writer.drain()
        else:
            writer.write_eof()          # the host goes away mid-session
        while True:
            data = await reader.read(65536)
            if not data:
                break
            got.extend(data)
        writer.close()
        done.set()

    server = await asyncio.start_server(host, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    client = client_cls("127.0.0.1", port, **kw)
    client.trajectory_path = str(tum_path)
    await client.run()
    await asyncio.wait_for(done.wait(), 10)
    server.close()
    await server.wait_closed()
    return bytes(got), client


CASES = {"plain": (1.0, True, True), "scaled_numpy": (0.5, False, True),
         "scaled_cv2": (0.75, True, True), "lost_host": (1.0, False, False)}


class TestBackendClientStub:
    @pytest.mark.parametrize("case", list(CASES))
    def test_bytes_equal_jax(self, case, stubbed, tmp_path, monkeypatch,
                             capsys):
        scale, cv2_present, terminate = CASES[case]
        pkts = host_packets(scale, cv2_present and case == "plain")
        if not cv2_present:
            monkeypatch.setitem(sys.modules, "cv2", None)
        if case == "plain":
            monkeypatch.delenv("SLAM_SKIP_WARMUP", raising=False)
        results = {}
        for name, cls, kw in (("jax", jbc.BackendClient, {}),
                              ("torch", tbc.BackendClient,
                               {"device": "cpu"})):
            raw, client = asyncio.run(asyncio.wait_for(serve_host(
                cls, pkts, terminate, tmp_path / f"{name}.txt", **kw), 30))
            results[name] = (raw, client, capsys.readouterr().out,
                             (tmp_path / f"{name}.txt").read_text())
        (jraw, jcl, jout, jtum), (traw, tcl, tout, ttum) = \
            results["jax"], results["torch"]
        assert traw == jraw
        got = tproto.PacketDecoder().feed(traw)
        # Call k gets SCRIPT[k % 5]: calls 1 and 3 are OK, call 1 with
        # two backfill poses sent before its live one.
        n = len(StubSystem.made[-1].images)
        n_ok = sum(k % 5 in (1, 3) for k in range(n))
        n_bf = sum(k % 5 == 1 for k in range(n))
        assert len(got) == n_ok + 2 * n_bf > 0
        assert all(p["type"] == "pose" and p["tracking_state"] == 2
                   and p["camera_id"] == 3 for p in got)
        assert got[0]["timestamp"] < got[1]["timestamp"] \
            < got[2]["timestamp"]
        js, ts = StubSystem.made
        assert len(ts.images) == len(js.images) == 8 + (case == "plain")
        for a, b in zip(ts.images, js.images):
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b)
        want = (int(48 * scale), int(64 * scale))
        assert ts.images[0].shape == want
        assert ts.cfg == tbc._config_from_calibration(
            tbc._scaled_calibration(pkts[0]))
        assert (tcl.image_scale, tcl.frames_seen, tcl.track_times) \
            == (jcl.image_scale, jcl.frames_seen, jcl.track_times)
        assert ts.warmups == js.warmups \
            == (["float32"] if case == "plain" else [])
        assert ts.shutdowns == js.shutdowns == 1
        assert tout == jout and "median tracking time:" in tout
        assert ttum == jtum == ts.keyframe_trajectory_tum()

    def test_resize_branches_equal_jax(self, monkeypatch):
        gray = np.random.default_rng(1).integers(0, 256, (48, 64)).astype(
            np.uint8)
        for scale in (0.5, 0.75, 1.5):
            assert np.array_equal(tbc._resize_gray(gray, scale),
                                  jbc._resize_gray(gray, scale))
        monkeypatch.setitem(sys.modules, "cv2", None)
        for scale in (0.5, 0.75):
            got = tbc._resize_gray(gray, scale)
            assert np.array_equal(got, jbc._resize_gray(gray, scale))
            assert got.shape == (int(48 * scale), int(64 * scale))

    def test_flagship_calibration_builds_the_flagship_config(self):
        pkt = tproto.build_calibration_packet(0, 0.0, 640, 480, 520.0,
                                              520.0, 320.0, 240.0)
        assert tbc._config_from_calibration(tbc._scaled_calibration(pkt)) \
            == EngineConfig(camera=CameraConfig(
                width=640, height=480, fx=520.0, fy=520.0, cx=320.0,
                cy=240.0))


class TestEngineWorkerStub:
    @pytest.mark.parametrize("warm", [False, True])
    def test_poses_and_stats_equal_jax(self, warm, stubbed, monkeypatch):
        if warm:
            monkeypatch.delenv("SLAM_SKIP_WARMUP", raising=False)
        rng = np.random.default_rng(2)
        frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
                  for _ in range(7)] + [rng.integers(0, 256, (24, 32),
                                                     dtype=np.uint8)]

        async def go(ew, bus_mod, prod_mod, **kw):
            bus = bus_mod.Bus(maxsize=16)
            worker = ew.EngineWorker(bus, EngineConfig(), **kw)
            poses_q = bus.subscribe(bus_mod.POSE)
            task = asyncio.create_task(worker.run())
            while not bus._subs.get(bus_mod.CAMERA):
                await asyncio.sleep(0.01)
            for k, f in enumerate(frames):
                bus.publish(bus_mod.CAMERA, prod_mod.FrameEvent(
                    frame=f, timestamp=5.0 + k, fps=30.0, camera_id=1))
                while worker.frames_in <= k:
                    await asyncio.sleep(0.005)
            worker.stop()
            await asyncio.wait_for(task, 5)
            out = [poses_q.get_nowait() for _ in range(poses_q.qsize())]
            return out, worker.stats(), worker.system

        jp, jstats, js = asyncio.run(go(jew, jbus, jprod))
        tp, tstats, ts = asyncio.run(go(tew, tbus, tprod, device="cpu"))
        assert [tproto.frame_packet_bytes(p) for p in tp] \
            == [jproto.frame_packet_bytes(p) for p in jp]
        assert len(tp) == 3 + 2 * 2       # calls 1, 3, 6 OK; 1, 6 backfill
        assert tstats == jstats
        assert tstats["frames"] == 8 and tstats["tracked"] == len(tp)
        assert tstats["n_keyframes"] == 3 and tstats["loops_closed"] == 1
        for a, b in zip(ts.images, js.images):
            assert a.dtype == np.float32 and np.array_equal(a, b)
        assert ts.warmups == js.warmups == (["float32"] if warm else [])


# ---------------------------------------------------------------------------
# The port's real System on the CPU


def small_config(cam):
    """tests/test_backend_client.py:23's configuration."""
    return EngineConfig(
        orb=OrbConfig(n_features=512, n_levels=4),
        camera=CameraConfig(
            width=int(cam["width"]), height=int(cam["height"]),
            fx=float(cam["fx"]), fy=float(cam["fy"]),
            cx=float(cam["cx"]), cy=float(cam["cy"])),
        map=MapConfig(max_keyframes=16, max_landmarks=1024, ba_window=4),
        tracking=TrackingConfig(init_min_matches=50, init_collapse_frac=0.0))


@pytest.fixture(scope="module")
def scene():
    world = SyntheticWorld(n_points=600)
    ts, Rs, tls = world.trajectory(n_frames=N_FRAMES)
    frames = [world.render(Rs[k], tls[k]).astype(np.uint8)
              for k in range(N_FRAMES)]
    calib = tproto.build_calibration_packet(
        0, 0.0, world.W, world.H, world.fx, world.fy, world.cx, world.cy)
    return world, ts, frames, calib


def library_run(cfg, frames, ts, warm):
    """track_monocular over the frames as the backend feeds them; the
    poses a backend would send, in its order: each frame's backfill,
    then its live OK pose stamped with the frame's own timestamp, as
    both packages' backends stamp it (the output's pose is the lagged
    frame's at ``pipeline_depth`` 1; ``out.timestamp`` names that
    frame)."""
    s = System(cfg, device="cpu")
    if warm:
        s.warmup(image_dtype=np.float32)
    sent, states = [], []
    for k, f in enumerate(frames):
        out = s.track_monocular(f.astype(np.float32), float(ts[k]))
        sent.extend(out.backfill)
        if out.tracking_state == TRACKING_OK:
            sent.append((float(ts[k]), out.position, out.orientation))
        states.append((out.tracking_state, s.get_tracking_state(), s.state))
    return dict(sent=sent, states=states, system=s,
                frames_extracted=s.frames_extracted, n_kf=s._n_kf_host,
                n_lm=int(s.map.n_landmarks()))


@pytest.fixture(scope="module")
def unwarmed(scene):
    _world, ts, frames, calib = scene
    return library_run(small_config(calib["camera"]), frames, ts, False)


def same_poses(a, b):
    return len(a) == len(b) and all(
        x[0] == y[0] and np.array_equal(x[1], y[1])
        and np.array_equal(x[2], y[2]) for x, y in zip(a, b))


class TestRealSystem:
    def test_wire_poses_equal_library_path(self, scene, unwarmed, tmp_path,
                                           monkeypatch):
        """The backend warms up (SLAM_SKIP_WARMUP unset) and serves the
        library path's poses, bit for bit, over P6 frames."""
        monkeypatch.delenv("SLAM_SKIP_WARMUP", raising=False)
        _world, ts, frames, calib = scene
        got = []

        async def host(reader, writer):
            writer.write(tproto.frame_packet_bytes(calib))
            for k, f in enumerate(frames):
                writer.write(tproto.frame_packet_bytes(
                    tproto.build_frame_packet(
                        0, float(ts[k]), f.shape[1], f.shape[0],
                        encode_ppm(np.repeat(f[..., None], 3, axis=2)))))
            writer.write(tproto.frame_packet_bytes(
                tproto.build_terminate_packet()))
            await writer.drain()
            dec = tproto.PacketDecoder()
            while data := await reader.read(65536):
                got.extend(dec.feed(data))
            writer.close()

        async def go():
            server = await asyncio.start_server(host, "127.0.0.1", 0)
            client = tbc.BackendClient(
                "127.0.0.1", server.sockets[0].getsockname()[1],
                config_factory=lambda pkt: small_config(pkt["camera"]),
                device="cpu")
            client.trajectory_path = str(tmp_path / "kf.txt")
            await client.run()
            server.close()
            await server.wait_closed()
            return client

        client = asyncio.run(asyncio.wait_for(go(), 300))
        assert client.frames_seen == N_FRAMES
        want = unwarmed["sent"]
        assert len(want) >= 10
        wire = [(p["timestamp"],
                 np.asarray([p["position"][c] for c in "xyz"], np.float64),
                 np.asarray([p["orientation"][c] for c in "xyzw"],
                            np.float64)) for p in got]
        assert all(p["tracking_state"] == TRACKING_OK for p in got)
        assert same_poses(wire, [(t, np.asarray(p, np.float64),
                                  np.asarray(q, np.float64))
                                 for t, p, q in want])
        s = client.system
        assert (s.frames_extracted, s._n_kf_host, int(s.map.n_landmarks())) \
            == (unwarmed["frames_extracted"], unwarmed["n_kf"],
                unwarmed["n_lm"])
        lines = (tmp_path / "kf.txt").read_text().strip().splitlines()
        n_valid = int(s.map.kf_valid[:int(s.map.n_kf)].sum())
        assert len(lines) == n_valid >= 2
        assert all(len(ln.split()) == 8 for ln in lines)

    def test_warmup_leaves_the_session_bit_equal(self, scene, unwarmed):
        _world, ts, frames, calib = scene
        warmed = library_run(small_config(calib["camera"]), frames, ts, True)
        assert same_poses(warmed["sent"], unwarmed["sent"])
        for key in ("frames_extracted", "n_kf", "n_lm", "states"):
            assert warmed[key] == unwarmed[key], key
        s = warmed["system"]
        assert s.polish_slices_run == unwarmed["system"].polish_slices_run
        assert s.atlas == [] and s.loops_closed == 0

    def test_get_tracking_state(self, scene, unwarmed):
        cfg = small_config(scene[3]["camera"])
        assert System(cfg, device="cpu").get_tracking_state() == 0
        states = unwarmed["states"]
        assert all(g == s for _o, g, s in states)
        assert states[0][1] == 1 and states[-1][1] == TRACKING_OK


# ---------------------------------------------------------------------------
# The application


class TestApplication:
    def test_saved_calibration_equals_jax(self, tmp_path, monkeypatch):
        calib = {"camera_matrix": np.array([[510.0, 0, 321], [0, 512, 239],
                                            [0, 0, 1]]),
                 "distortion_coeffs": np.array([[0.1, -0.2, 1e-3, 2e-3,
                                                 0.05]]),
                 "reprojection_error": 0.31, "successful_frames": 14}
        assert tcalib_io.calibration_to_json(calib) \
            == jcalib_io.calibration_to_json(calib)
        path = tmp_path / "latest.json"
        monkeypatch.setenv("SEND_SLAM_CALIBRATION_FILE", str(path))
        assert tcalib_io.save_to_file(calib) == str(path)
        back = tcalib_io.load_from_file()
        assert back["successful_frames"] == 14
        assert np.array_equal(back["camera_matrix"], calib["camera_matrix"])
        tcam = tapp.Application._config_with_saved_calibration().camera
        jcam = japp.Application._config_with_saved_calibration().camera
        assert {f: getattr(tcam, f) for f in tcam.__dataclass_fields__} \
            == {f: getattr(jcam, f) for f in jcam.__dataclass_fields__}
        assert tcam.fx == 510.0 and tcam.k3 == 0.05

    def test_app_end_to_end(self, tmp_path):
        """Video replay of a .ppm sequence -> the engine on the CPU ->
        the pose stream on /client, /metrics and the panel page."""
        world = SyntheticWorld(n_points=600)
        ts, Rs, tls = world.trajectory(n_frames=30)
        for k in range(30):
            img = world.render(Rs[k], tls[k]).astype(np.uint8)
            (tmp_path / f"frame_{k:06d}.ppm").write_bytes(
                encode_ppm(np.repeat(img[..., None], 3, axis=2)))
        cfg = EngineConfig(
            orb=OrbConfig(n_features=512, n_levels=4),
            camera=CameraConfig(width=world.W, height=world.H,
                                fx=world.fx, fy=world.fy,
                                cx=world.cx, cy=world.cy, fps=10.0),
            map=MapConfig(max_keyframes=32, max_landmarks=2048, ba_window=4),
            tracking=TrackingConfig(init_min_matches=50),
            server=ServerConfig(http_port=0, tcp_port=0))

        async def go():
            app = tapp.Application(
                config=cfg, video=str(tmp_path / "frame_%06d.ppm"),
                run_engine=True, run_tcp=True, run_web=True, device="cpu")
            await app.start()
            try:
                port = app.web.bound_port
                async with aiohttp.ClientSession() as sess:
                    async with sess.ws_connect(
                            f"http://127.0.0.1:{port}/client") as ws:
                        data = json.loads(await asyncio.wait_for(
                            ws.receive_str(), 240))
                        assert data["type"] == "pose"
                        assert data["payload"]["tracking_state"] == 2
                        assert set(data["payload"]["position"]) \
                            == {"x", "y", "z"}
                    async with sess.get(
                            f"http://127.0.0.1:{port}/metrics") as resp:
                        stats = await resp.json()
                        assert stats["frames"] > 0
                        assert stats["n_keyframes"] >= 2
                    async with sess.get(f"http://127.0.0.1:{port}/") as resp:
                        assert resp.status == 200
                assert app.tcp.bound_port > 0
            finally:
                await app.stop()

        asyncio.run(asyncio.wait_for(go(), 300))
