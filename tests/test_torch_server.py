"""The port's server layer against the JAX package's, on the CPU.

The bus, the :5000 TCP listener (its outbound bytes for the same frame
events, ``time.time`` patched in both), the ``/client`` and
``pose_server`` ``/ws`` pose streams (the JSON text the JAX
``WebPanel`` sends for the same poses, read with ``aiohttp``'s client
and with ``chip_smoke.py``'s raw masked client), ``/metrics`` and ``/``,
ping/pong and close, the process manager and the profiling helpers. No
engine runs here (``tests/test_torch_backend.py`` has it).
"""

import asyncio
import json
import os
import time

import aiohttp
import numpy as np
import pytest

import chip_smoke
from send_slam_tpu.io import protocol as jproto
from send_slam_tpu.server import bus as jbus
from send_slam_tpu.server import process_manager as jpm
from send_slam_tpu.server import producers as jprod
from send_slam_tpu.server import tcp as jtcp
from send_slam_tpu.server import web as jweb
from send_slam_tpu.utils import profiling as jprof
from send_slam_tpu_torch.io import protocol as tproto
from send_slam_tpu_torch.io.ppm import decode_ppm
from send_slam_tpu_torch.server import bus as tbus
from send_slam_tpu_torch.server import http as thttp
from send_slam_tpu_torch.server import pose_server as tpose
from send_slam_tpu_torch.server import process_manager as tpm
from send_slam_tpu_torch.server import producers as tprod
from send_slam_tpu_torch.server import tcp as ttcp
from send_slam_tpu_torch.server import web as tweb
from send_slam_tpu_torch.utils import profiling as tprof

BUSES = pytest.mark.parametrize("bus_mod", [jbus, tbus], ids=["jax", "torch"])


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_events(prod, n=3, calib=None):
    rng = np.random.default_rng(0)
    return [prod.FrameEvent(
        frame=rng.integers(0, 255, (24, 32, 3), dtype=np.uint8),
        timestamp=1.25 + k, fps=30.0, camera_id=k % 2,
        calibration=calib if k == 0 else None) for k in range(n)]


def poses():
    return [jproto.build_pose_packet(2.0 + k, k % 2, 2,
                                     (0.1 * k, -0.2, 1e-9 * k),
                                     (0.0, 0.6, 0.0, 0.8))
            for k in range(4)] + [jproto.build_pose_packet(
                1700000000.5, 0, 3, (1.5, 2.5, 3.5), (0.5, 0.5, 0.5, 0.5))]


async def wait_subscribed(bus, topic, n):
    for _ in range(500):
        if len(bus._subs.get(topic, ())) >= n:
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"no {n} subscribers on {topic}")


class TestBus:
    @BUSES
    def test_pubsub_fanout(self, bus_mod):
        async def go():
            bus = bus_mod.Bus()
            q1, q2 = bus.subscribe("t"), bus.subscribe("t")
            bus.publish("t", 42)
            assert await q1.get() == 42 and await q2.get() == 42
            bus.unsubscribe("t", q1)
            bus.publish("t", 43)
            assert q1.empty() and await q2.get() == 43
        run(go())

    @BUSES
    def test_slow_consumer_drops_oldest(self, bus_mod):
        async def go():
            bus = bus_mod.Bus(maxsize=2)
            q = bus.subscribe("t")
            for i in range(5):
                bus.publish("t", i)
            assert [await q.get(), await q.get()] == [3, 4]
        run(go())

    def test_topics_equal(self):
        for name in ("CAMERA", "POSE", "CALIBRATION", "BACKEND",
                     "WEBSOCKET"):
            assert getattr(tbus, name) == getattr(jbus, name)


async def tcp_bytes(tcp_mod, bus_mod, prod_mod, calib, n_events):
    """Every byte the listener sends a first connection for ``n_events``
    frame events, the packets, the pose packets it publishes, and what a
    second connection gets at once (the cached calibration)."""
    bus = bus_mod.Bus(maxsize=16)
    srv = tcp_mod.TcpFrameServer(bus, port=0)
    await srv.start()
    reader, writer = await asyncio.open_connection("127.0.0.1",
                                                   srv.bound_port)
    await wait_subscribed(bus, bus_mod.CAMERA, 1)
    poses_q = bus.subscribe(bus_mod.POSE)
    for ev in make_events(prod_mod, n_events, calib):
        bus.publish(bus_mod.CAMERA, ev)
    dec, raw, pkts = tproto.PacketDecoder(), b"", []
    while len(pkts) < n_events + (calib is not None):
        data = await asyncio.wait_for(reader.read(65536), 5)
        assert data
        raw += data
        pkts.extend(dec.feed(data))
    for p in poses():
        writer.write(jproto.frame_packet_bytes(p))
    await writer.drain()
    got = [await asyncio.wait_for(poses_q.get(), 5) for _ in poses()]
    replay = b""
    if calib is not None:
        r2, w2 = await asyncio.open_connection("127.0.0.1", srv.bound_port)
        replay = await asyncio.wait_for(r2.read(65536), 5)
        w2.close()
    writer.close()
    await srv.stop()
    return raw, pkts, got, replay


CALIB = {"camera_matrix": np.array([[500.0, 0, 16], [0, 501, 12], [0, 0, 1]]),
         "distortion_coeffs": np.array([[0.1, -0.01, 0, 0, 0.002]])}


class TestTcpServer:
    @pytest.mark.parametrize("calib", [CALIB, None], ids=["calib", "none"])
    def test_outbound_bytes_equal_jax(self, calib, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: 1234.5)
        j = run(tcp_bytes(jtcp, jbus, jprod, calib, 3))
        t = run(tcp_bytes(ttcp, tbus, tprod, calib, 3))
        assert t[0] == j[0]                  # [calibration +] 3 frames
        frames = t[1][calib is not None:]
        assert [p["type"] for p in frames] == ["frame"] * 3
        assert np.array_equal(decode_ppm(frames[0]["frame"]),
                              make_events(tprod, 1)[0].frame)
        assert t[2] == j[2] == poses()       # poses in -> POSE topic
        assert t[3] == j[3]                  # cached calibration replayed
        if calib is not None:
            assert t[1][0]["type"] == "calibration" and t[3]
            assert t[1][0]["timestamp"] == 1234.5
            assert ttcp.calibration_packet_from_dict(
                calib, 1, 32, 24, 15.0) == jtcp.calibration_packet_from_dict(
                calib, 1, 32, 24, 15.0)


async def jax_panel(bus, metrics_fn=None):
    panel = jweb.WebPanel(bus, host="127.0.0.1", port=0,
                          metrics_fn=metrics_fn)
    await panel.start()
    return panel, panel._runner.addresses[0][1]


async def torch_panel(bus, metrics_fn=None):
    panel = tweb.WebPanel(bus, host="127.0.0.1", port=0,
                          metrics_fn=metrics_fn)
    await panel.start()
    return panel, panel.bound_port


async def pose_texts(bus_mod, start, path, raw):
    """The texts a client of ``path`` reads for ``poses()``: with
    aiohttp's client, or chip_smoke.py's raw masked one."""
    bus = bus_mod.Bus(maxsize=16)
    server, port = await start(bus)
    try:
        if raw:
            ws = await chip_smoke.WsClient.connect(port, path)
        else:
            sess = aiohttp.ClientSession()
            ws = await sess.ws_connect(f"http://127.0.0.1:{port}{path}")
        await wait_subscribed(bus, bus_mod.POSE, 1)
        for p in poses():
            bus.publish(bus_mod.POSE, p)
        texts = []
        for _ in poses():
            texts.append(await asyncio.wait_for(
                ws.recv_text() if raw else ws.receive_str(), 5))
        if raw:
            assert await ws.close() == 1000
        else:
            await ws.close()
            await sess.close()
        for _ in range(200):        # the route unsubscribes on close
            if not bus._subs.get(bus_mod.POSE):
                break
            await asyncio.sleep(0.01)
        assert not bus._subs.get(bus_mod.POSE)
        return texts
    finally:
        await server.stop()


async def jax_pose_server(bus):
    from send_slam_tpu.server.pose_server import PoseServer
    srv = PoseServer(bus, host="127.0.0.1", port=0)
    await srv.start()
    return srv, srv._runner.addresses[0][1]


async def torch_pose_server(bus):
    srv = tpose.PoseServer(bus, host="127.0.0.1", port=0)
    await srv.start()
    return srv, srv.bound_port


class TestPoseStreams:
    @pytest.mark.parametrize("raw", [False, True], ids=["aiohttp", "raw"])
    def test_client_json_text_equal_jax(self, raw):
        want = [json.dumps(jproto.pose_ws_json(p)) for p in poses()]
        j = run(pose_texts(jbus, jax_panel, "/client", raw))
        t = run(pose_texts(tbus, torch_panel, "/client", raw))
        assert j == want and t == want

    @pytest.mark.parametrize("raw", [False, True], ids=["aiohttp", "raw"])
    def test_pose_server_ws_equal_jax(self, raw):
        j = run(pose_texts(jbus, jax_pose_server, "/ws", raw))
        t = run(pose_texts(tbus, torch_pose_server, "/ws", raw))
        assert t == j and len(t) == len(poses())

    def test_ping_pong_close_and_inbound_text(self):
        async def go():
            bus = tbus.Bus()
            panel, port = await torch_panel(bus)
            try:
                ws = await chip_smoke.WsClient.connect(port, "/client")
                await ws.send(0x1, b"ignored by the route")
                await ws.send(0x9, b"x" * 200)      # 16-bit length
                assert await asyncio.wait_for(ws.recv(), 5) \
                    == (0xA, b"x" * 200)
                await ws.send(0x9, b"")
                assert await asyncio.wait_for(ws.recv(), 5) == (0xA, b"")
                assert await asyncio.wait_for(ws.close(4001), 5) == 4001
            finally:
                await panel.stop()
        run(go())

    def test_long_frames_and_bad_requests(self):
        async def go():
            bus = tbus.Bus()
            panel, port = await torch_panel(bus)
            try:
                ws = await chip_smoke.WsClient.connect(port, "/client")
                await wait_subscribed(bus, tbus.POSE, 1)
                big = tproto.build_pose_packet(1.0, 0, 2, (1, 2, 3),
                                               (0, 0, 0, 1))
                big["note"] = "y" * 70000           # 64-bit length
                bus.publish(tbus.POSE, big)
                assert json.loads(await asyncio.wait_for(
                    ws.recv_text(), 5))["payload"] == big
                status, _ = await chip_smoke.http_get(port, "/client")
                assert status == 400                # not an upgrade
                status, body = await chip_smoke.http_get(port, "/nope")
                assert status == 404
                r, w = await asyncio.open_connection("127.0.0.1", port)
                w.write(b"POST / HTTP/1.1\r\nHost: x\r\n\r\n")
                assert (await r.read()).startswith(b"HTTP/1.1 405")
                w.close()
                # stop() ends the open WebSocket.
            finally:
                await panel.stop()
            with pytest.raises((asyncio.IncompleteReadError,
                                ConnectionError)):
                await asyncio.wait_for(ws.recv(), 5)
        run(go())

    def test_accept_key_rfc_example(self):
        # RFC 6455 section 1.3's worked example.
        assert thttp.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") \
            == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


async def panel_exchange(start, bus_mod, prod_mod, events, texts,
                         fragments=1):
    """Open ``/panel`` with chip_smoke.py's raw client: publish
    ``events`` on CAMERA and read one binary message each, then send each
    of ``texts`` (in ``fragments`` frames, a ping between the first two)
    and read the text reply, if any, of each (None when there is none
    within 2 s past a calibration's). Returns (binary messages, replies,
    CALIBRATION messages published)."""
    bus = bus_mod.Bus(maxsize=16)
    calib_q = bus.subscribe(bus_mod.CALIBRATION)
    server, port = await start(bus)
    try:
        ws = await chip_smoke.WsClient.connect(port, "/panel")
        await wait_subscribed(bus, bus_mod.CAMERA, 1)
        frames = []
        for ev in events:
            bus.publish(bus_mod.CAMERA, ev)
            op, data = await asyncio.wait_for(ws.recv(), 10)
            assert op == 0x2
            frames.append(data)
        replies = []
        for text in texts:
            data = text.encode()
            step = -(-len(data) // fragments)
            parts = [data[i:i + step] for i in range(0, len(data), step)]
            for i, part in enumerate(parts):
                await ws.send(0x0 if i else 0x1, part,
                              fin=i == len(parts) - 1)
                if i == 0 and len(parts) > 1:
                    await ws.send(0x9, b"between")
            reply = None
            try:
                while reply is None:
                    op, got = await asyncio.wait_for(ws.recv(), 120 if
                                                     "calibrationFrames"
                                                     in text else 2)
                    if op == 0x1:
                        reply = got.decode()
            except asyncio.TimeoutError:
                pass
            replies.append(reply)
        assert await ws.close() == 1000
        for _ in range(200):        # the route unsubscribes on close
            if not bus._subs.get(bus_mod.CAMERA):
                break
            await asyncio.sleep(0.01)
        assert not bus._subs.get(bus_mod.CAMERA)
        published = []
        while not calib_q.empty():
            published.append(calib_q.get_nowait())
        return frames, replies, published
    finally:
        await server.stop()


async def torch_cpu_panel(bus):
    """The port's panel, calibrating on the CPU."""
    panel = tweb.WebPanel(bus, host="127.0.0.1", port=0, device="cpu")
    await panel.start()
    return panel, panel.bound_port


def board_upload(n=12):
    """tests/test_calibration.py's board views as the browser uploads
    them: JPEG data URLs."""
    import base64
    import cv2
    from test_calibration import board_views
    urls = []
    for _, _, img in board_views(n):
        ok, buf = cv2.imencode(".jpg", np.round(img).astype(np.uint8))
        urls.append("data:image/jpeg;base64,"
                    + base64.b64encode(buf.tobytes()).decode())
    return urls


class TestPanel:
    def test_jpeg_frames_down_as_jax(self):
        """Each CAMERA frame comes down as a JPEG that cv2 decodes to the
        JAX panel's picture; then a bad upload is answered "ERROR"."""
        import cv2
        rng = np.random.default_rng(5)
        frames = [rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                  for _ in range(3)]
        out = {}
        for name, start, bus_mod, prod_mod in (
                ("jax", jax_panel, jbus, jprod),
                ("torch", torch_cpu_panel, tbus, tprod)):
            evs = [prod_mod.FrameEvent(frame=f, timestamp=1.0 + k, fps=30.0,
                                       camera_id=0)
                   for k, f in enumerate(frames)]
            out[name] = run(panel_exchange(start, bus_mod, prod_mod, evs,
                                           ["not json", '{"x": 1}',
                                            '{"calibrationFrames": ["!!!"]}']),
                            timeout=180)
        for (jf, jr, jp), (tf, tr, tp) in [(out["jax"], out["torch"])]:
            assert len(jf) == len(tf) == 3
            for a, b, f in zip(jf, tf, frames):
                da = cv2.imdecode(np.frombuffer(a, np.uint8), cv2.IMREAD_COLOR)
                db = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
                assert da.shape == db.shape == f.shape
                assert np.abs(da.astype(int) - db).max() <= 2
            assert jr == tr == ["ERROR", None, "ERROR"]
            assert jp == tp == []

    def test_calibration_upload_fragmented(self, tmp_path, monkeypatch):
        """A fragmented upload of the rendered boards (a ping between its
        frames; aiohttp joins them for the JAX panel, the port's server
        joins them too): "OK", the reference JSON written, and one
        CALIBRATION publish, with the JAX panel's camera matrix."""
        from send_slam_tpu_torch.calib.io import ENV_VAR, load_from_file
        upload = json.dumps({"calibrationFrames": board_upload()})
        got = {}
        for name, start, bus_mod, prod_mod in (
                ("jax", jax_panel, jbus, jprod),
                ("torch", torch_cpu_panel, tbus, tprod)):
            path = tmp_path / name / "latest.json"
            monkeypatch.setenv(ENV_VAR, str(path))
            _, replies, published = run(panel_exchange(
                start, bus_mod, prod_mod, [], [upload], fragments=3),
                timeout=240)
            assert replies == ["OK"]
            assert len(published) == 1
            saved = json.loads(path.read_text())
            assert saved["camera_matrix"]["shape"] == [3, 3]
            assert saved["distortion_coeffs"]["shape"] == [1, 5]
            got[name] = (load_from_file(str(path)), published[0])
        (js, jp), (ts_, tp) = got["jax"], got["torch"]
        K_j, K_t = js["camera_matrix"], ts_["camera_matrix"]
        assert np.abs(K_t - K_j).max() / np.abs(K_j).max() <= 1e-4
        assert ts_["successful_frames"] == js["successful_frames"] >= 10
        np.testing.assert_allclose(tp["camera_matrix"], K_t, rtol=1e-12)

    def test_pongs_ignored_as_jax(self):
        """A pong before a message and pongs between its fragments
        (RFC 6455 section 5.5.3 allows both) are ignored, as aiohttp
        ignores them for the JAX panel: the joined message is answered
        and the connection stays open."""
        async def go(start, bus_mod):
            bus = bus_mod.Bus()
            server, port = await start(bus)
            try:
                ws = await chip_smoke.WsClient.connect(port, "/panel")
                await ws.send(0xA, b"heartbeat")
                await ws.send(0x1, b"not ", fin=False)
                await ws.send(0xA, b"")
                await ws.send(0x0, b"js", fin=False)
                await ws.send(0xA, b"again")
                await ws.send(0x0, b"on", fin=True)
                op, data = await asyncio.wait_for(ws.recv(), 5)
                code = await ws.close()
                return op, data, code
            finally:
                await server.stop()

        want = (0x1, b"ERROR", 1000)
        assert run(go(jax_panel, jbus)) == want
        assert run(go(torch_cpu_panel, tbus)) == want

    def test_fragment_protocol_errors_close(self, monkeypatch):
        """A continuation without a message closes with 1002, a message
        over the size guard with 1009."""
        async def go(frames):
            bus = tbus.Bus()
            panel, port = await torch_cpu_panel(bus)
            try:
                ws = await chip_smoke.WsClient.connect(port, "/panel")
                for op, data, fin in frames:
                    await ws.send(op, data, fin=fin)
                while True:
                    op, data = await asyncio.wait_for(ws.recv(), 5)
                    if op == 0x8:
                        return int.from_bytes(data[:2], "big")
            finally:
                await panel.stop()

        assert run(go([(0x0, b"stray", True)])) == 1002
        assert run(go([(0x1, b"a", False), (0xA, b"", True),
                       (0x1, b"b", True)])) == 1002
        assert run(go([(0x1, b"a", False), (0x1, b"b", True)])) == 1002
        monkeypatch.setattr(thttp, "MAX_WS_FRAME", 100)
        assert run(go([(0x1, b"x" * 60, False),
                       (0x0, b"y" * 60, True)])) == 1009


class TestHttpRoutes:
    def test_metrics_and_index_equal_jax(self):
        stats = {"frames": 3, "tracked": 2, "tracking_state": 2,
                 "n_keyframes": 2, "stages": {"a": {"count": 1}}}

        async def fetch(start):
            bus = tbus.Bus()
            server, port = await start(bus, lambda: stats)
            try:
                async with aiohttp.ClientSession() as sess:
                    async with sess.get(
                            f"http://127.0.0.1:{port}/metrics") as resp:
                        assert resp.status == 200
                        metrics = await resp.json()
                    async with sess.get(f"http://127.0.0.1:{port}/") as resp:
                        index = (resp.status, await resp.read())
                raw = await chip_smoke.http_get(port, "/metrics")
                return metrics, index, raw
            finally:
                await server.stop()

        jm, ji, jr = run(fetch(jax_panel))
        tm, ti, tr = run(fetch(torch_panel))
        assert tm == jm == stats
        assert ti == ji and ti[0] == 200 and b"SEND-SLAM" in ti[1]
        assert tr[0] == jr[0] == 200 and json.loads(tr[1]) == stats

    def test_bound_port_and_restart(self):
        async def go():
            srv = thttp.HttpServer("127.0.0.1", 0)

            async def hello(request):
                return thttp.Response(200, b"hi")

            async def blob(request):
                ws = await srv.upgrade(request)
                for n in (5, 300, 70000):           # 7, 16, 64-bit lengths
                    await ws.send_bytes(bytes(range(256)) * (n // 256)
                                        + bytes(n % 256))
                async for _ in ws:
                    pass

            srv.add_get("/h", hello)
            srv.add_get("/blob", blob)
            await srv.start()
            port = srv.bound_port
            assert port > 0
            assert await chip_smoke.http_get(port, "/h?x=1") == (200, b"hi")
            ws = await chip_smoke.WsClient.connect(port, "/blob")
            for n in (5, 300, 70000):
                op, data = await asyncio.wait_for(ws.recv(), 5)
                assert op == 0x2 and data == bytes(range(256)) * (n // 256) \
                    + bytes(n % 256)
            assert await ws.close() == 1000
            await srv.stop()
            await srv.stop()                # idempotent
            with pytest.raises(OSError):
                await chip_smoke.http_get(port, "/h")
        run(go())


class TestProducers:
    def test_ppm_sequence_equals_jax_cv2(self, tmp_path):
        """The port reads P6/P5 files itself; the JAX producer reads the
        same files with cv2.imread."""
        rng = np.random.default_rng(3)
        rgb = [rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
               for _ in range(3)]
        gray = rng.integers(0, 256, (12, 16), dtype=np.uint8)
        from send_slam_tpu.io.ppm import encode_ppm
        for k, img in enumerate(rgb):
            (tmp_path / f"{k:06d}.ppm").write_bytes(encode_ppm(img))
        (tmp_path / "000003.ppm").write_bytes(encode_ppm(gray))
        pgm = tmp_path / "g"
        pgm.mkdir()
        (pgm / "a.pgm").write_bytes(encode_ppm(gray))
        pattern = str(tmp_path / "%06d.ppm")
        t = list(tprod.VideoProducer(None, pattern)._frames())
        j = list(jprod.VideoProducer(None, pattern)._frames())
        assert len(t) == len(j) == 4
        for a, b in zip(t, j):
            assert np.array_equal(a, b)
        assert np.array_equal(tprod.read_image(str(pgm / "a.pgm")),
                              np.repeat(gray[..., None], 3, axis=2))
        assert [f.shape for f in tprod.VideoProducer(
            None, str(pgm))._frames()] == [(12, 16, 3)]
        (tmp_path / "000004.ppm").write_bytes(b"P6 broken")
        assert len(list(tprod.VideoProducer(None, pattern)._frames())) == 4

    def test_replay_publishes_every_frame(self, tmp_path):
        from send_slam_tpu.io.ppm import encode_ppm
        imgs = [np.full((4, 6, 3), k, np.uint8) for k in range(5)]
        for k, img in enumerate(imgs):
            (tmp_path / f"{k:03d}.ppm").write_bytes(encode_ppm(img))

        async def go():
            bus = tbus.Bus(maxsize=16)
            q = bus.subscribe(tbus.CAMERA)
            prod = tprod.VideoProducer(bus, str(tmp_path / "%03d.ppm"),
                                       fps=500.0, camera_id=2, loop=False)
            await prod.run()
            evs = [q.get_nowait() for _ in range(q.qsize())]
            assert [int(e.frame[0, 0, 0]) for e in evs] == list(range(5))
            assert all(e.camera_id == 2 and e.fps == 500.0 for e in evs)
        run(go())

    def test_other_formats_need_cv2(self, tmp_path, monkeypatch):
        import sys
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError):
            tprod.read_image(str(tmp_path / "x.png"))
        with pytest.raises(ImportError):
            list(tprod.VideoProducer(None, str(tmp_path / "v.mp4"))._frames())
        with pytest.raises(ImportError):
            tprod.CameraProducer(None)._open()


PMS = pytest.mark.parametrize("pm", [jpm, tpm], ids=["jax", "torch"])


class TestProcessManager:
    @PMS
    def test_prefix_stripped(self, pm, monkeypatch):
        monkeypatch.setenv("ORBSLAM3_MAP_PATH", "/data/maps")
        monkeypatch.setenv("ORBSLAM3_FOO", "bar")
        env = pm.env_passthrough({"BASE": "1"})
        assert env["MAP_PATH"] == "/data/maps"
        assert env["FOO"] == "bar" and env["BASE"] == "1"

    @PMS
    def test_start_status_logs_stop(self, pm):
        async def go():
            mgr = pm.ProcessManager("sh -c 'echo hello; sleep 30'",
                                    poll_interval=0.2)
            assert mgr.status() == "not_started"
            await mgr.start()
            for _ in range(50):
                await asyncio.sleep(0.1)
                if any("hello" in ln for ln in mgr.logs()):
                    break
            assert mgr.status() == "running"
            assert any("hello" in ln for ln in mgr.logs())
            await mgr.stop()
            assert mgr.status().startswith("exited")
        run(go())

    @PMS
    def test_auto_restart_on_death(self, pm):
        async def go():
            mgr = pm.ProcessManager("sh -c 'echo up'", poll_interval=0.1)
            await mgr.start()
            p1 = mgr._proc.pid
            for _ in range(50):
                await asyncio.sleep(0.2)
                if mgr._proc.pid != p1:
                    break
            assert mgr._proc.pid != p1, "backend was not respawned"
            await mgr.stop()
        run(go())


class TestProfiling:
    def test_stage_timer_equals_jax(self):
        samples = [("track", 0.012), ("track", 0.010), ("gray", 0.001),
                   ("track", 0.030)]
        jt, tt = jprof.StageTimer(max_samples=3), tprof.StageTimer(
            max_samples=3)
        for name, sec in samples:
            jt.add(name, sec)
            tt.add(name, sec)
        with tt.stage("ctx"):
            pass
        summary = tt.summary()
        assert summary.pop("ctx")["count"] == 1
        assert summary == jt.summary()
        assert tt.report().splitlines()[1:] == jt.report().splitlines()

    def test_device_trace_writes_a_trace(self, tmp_path):
        import torch
        with tprof.device_trace(str(tmp_path / "tr")):
            torch.ones(8).sum()
        assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
