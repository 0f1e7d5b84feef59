"""The port and chip_smoke.py import nothing of JAX or the JAX package,
nor ``msgpack``, ``aiohttp`` or ``cv2`` (the card's machine has none of
them), and the port never falls back to the CPU on its own."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys
    import numpy as np

    BLOCKED = ("jax", "jaxlib", "send_slam_tpu", "msgpack", "aiohttp",
               "cv2")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    import send_slam_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        send_slam_tpu_torch.__path__, "send_slam_tpu_torch.")]
    for name in ("send_slam_tpu_torch.models.atlas",
                 "send_slam_tpu_torch.io.map_io",
                 "send_slam_tpu_torch.io.msgpack_codec",
                 "send_slam_tpu_torch.io.protocol",
                 "send_slam_tpu_torch.io.native",
                 "send_slam_tpu_torch.io.ppm",
                 "send_slam_tpu_torch.utils.profiling",
                 "send_slam_tpu_torch.calib.io",
                 "send_slam_tpu_torch.parallel",
                 "send_slam_tpu_torch.parallel.mesh",
                 "send_slam_tpu_torch.parallel.multicam",
                 "send_slam_tpu_torch.parallel.map_merge",
                 *("send_slam_tpu_torch.server." + m for m in (
                     "app", "backend_client", "bus", "engine_worker",
                     "http", "pose_server", "process_manager", "producers",
                     "tcp", "web"))):
        assert name in mods, name
    for name in mods:
        importlib.import_module(name)
    import chip_smoke  # main() stays behind __name__ == "__main__"

    from send_slam_tpu_torch.config import CameraConfig, OrbConfig
    from send_slam_tpu_torch.models.frame import make_frame
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (96, 128)).astype(np.uint8)
    f = make_frame(img, 0.0, OrbConfig(n_features=64, n_levels=2),
                   CameraConfig(width=128, height=96, fx=100.0, fy=100.0,
                                cx=64.0, cy=48.0), device="cpu")
    assert f.feat.uv.shape == (64, 2) and f.feat.desc.shape == (64, 8)
    from send_slam_tpu_torch.io import protocol
    pkt = protocol.build_frame_packet(0, 1.5, 2, 1, b"P6 2 1 255 " + bytes(6))
    raw = protocol.frame_packet_bytes(pkt)
    assert protocol.PacketDecoder().feed(raw) == [pkt]
    bad = sorted(m for m in sys.modules
                 if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not bad, bad
    print("OK", len(mods))
""")


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, ROOT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_system_without_card_raises():
    import torch
    from send_slam_tpu_torch.config import EngineConfig
    from send_slam_tpu_torch.models.system import System
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        System(EngineConfig())


def test_server_entry_points_without_card_raise():
    """BackendClient, EngineWorker and Application run the engine on the
    card unless given device="cpu", and raise without one."""
    import torch
    from send_slam_tpu_torch.config import EngineConfig
    from send_slam_tpu_torch.server.app import Application
    from send_slam_tpu_torch.server.backend_client import BackendClient
    from send_slam_tpu_torch.server.bus import Bus
    from send_slam_tpu_torch.server.engine_worker import EngineWorker
    cfg = EngineConfig()
    made = [lambda **kw: BackendClient("127.0.0.1", 5000, **kw),
            lambda **kw: EngineWorker(Bus(), cfg, **kw),
            lambda **kw: Application(config=cfg, **kw)]
    cpu = torch.device("cpu")
    assert made[0](device="cpu").device == cpu
    assert made[1](device="cpu").system.device == cpu
    assert made[2](device="cpu").device == cpu
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for make in made:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device="cuda")


def test_server_mains_default_to_the_card():
    """``python -m`` of both entry points parses --device, default cuda,
    and fails without a card before it binds or dials anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for mod, args in (("send_slam_tpu_torch.server.backend_client",
                       ["--port", "1"]),
                      ("send_slam_tpu_torch.server.app", ["--no-engine"])):
        proc = subprocess.run([sys.executable, "-m", mod, *args], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert "no CUDA device is available" in proc.stderr, proc.stderr
        helped = subprocess.run([sys.executable, "-m", mod, "--help"],
                                cwd=ROOT, env=env, capture_output=True,
                                text=True, timeout=120)
        assert helped.returncode == 0 and "--device" in helped.stdout


def test_system_refuses_unported_features(tmp_path):
    """The JAX package's default configuration constructs, loop closing
    on, and so do BA windows up to the keyframe capacity; only other
    pyramid scales are refused at construction, and ``slice_config``
    (which turned loop closing off) is gone. Under the default
    configuration nothing raises at the freeze (the map is kept in the
    atlas), at the keyframe capacity (the table is compacted) or at map
    save and load."""
    from send_slam_tpu_torch.config import EngineConfig, MapConfig, OrbConfig
    from send_slam_tpu_torch.models import system as tsys
    cfg = EngineConfig()
    s = tsys.System(cfg, device="cpu")
    assert s.cfg.tracking.loop_min_gap_kf < cfg.map.max_keyframes
    assert s.cfg is cfg
    assert not hasattr(tsys, "slice_config")
    tsys.System(cfg.replace(map=MapConfig(max_keyframes=96, ba_window=96)),
                device="cpu")
    with pytest.raises(NotImplementedError, match="scale_factor"):
        tsys.System(cfg.replace(orb=OrbConfig(scale_factor=1.3)),
                    device="cpu")

    assert cfg.tracking.max_atlas_maps > 0
    s.state = tsys.TRACKING_OK
    s._maybe_compact(cfg.map.max_keyframes - 2)
    assert s._slots_used == 0 and s._compact_cooldown > 0
    s.save_map(str(tmp_path / "map.npz"))
    s.load_map(str(tmp_path / "map.npz"))
    assert s.state == tsys.TRACKING_LOST
    frozen = s.map
    s._freeze_to_atlas()
    assert len(s.atlas) == 1 and s.atlas[0] is frozen
