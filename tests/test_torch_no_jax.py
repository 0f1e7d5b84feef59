"""The port, chip_smoke.py and examples/run_dataset_torch.py import
nothing of JAX or the JAX package, nor, when a module loads, ``msgpack``,
``aiohttp``, ``cv2``, ``PIL`` or ``yaml`` (the JPEG codec and the
settings loader import ``PIL`` and ``yaml`` when called; PNG is read with
zlib and numpy alone), and the port never falls back to the CPU on its
own."""

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
               "cv2", "PIL", "yaml")

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
                 "send_slam_tpu_torch.calib.checkerboard",
                 "send_slam_tpu_torch.calib.zhang",
                 "send_slam_tpu_torch.calib.pipeline",
                 "send_slam_tpu_torch.io.jpeg",
                 "send_slam_tpu_torch.io.png",
                 "send_slam_tpu_torch.io.dataset",
                 "send_slam_tpu_torch.geometry",
                 "send_slam_tpu_torch.ops",
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
    import importlib.util, os
    spec = importlib.util.spec_from_file_location("run_dataset_torch",
        os.path.join(sys.argv[1], "examples", "run_dataset_torch.py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    from send_slam_tpu_torch.geometry import triangulate_dlt, rotmat_from_quat
    from send_slam_tpu_torch.ops import pack_bits_to_u32, extract_orb
    from send_slam_tpu_torch.io.png import decode_png
    from send_slam_tpu_torch.io.dataset import open_sequence
    png = chip_smoke.png_bytes(np.arange(12, dtype=np.uint8).reshape(3, 4),
                               (0, 4, 3))
    assert decode_png(png).tolist() == [[0, 1, 2, 3], [4, 5, 6, 7],
                                        [8, 9, 10, 11]]

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
    on, and so do BA windows up to the keyframe capacity and other
    pyramid scales (1.3), and ``slice_config``
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
    s13 = tsys.System(cfg.replace(orb=OrbConfig(scale_factor=1.3)),
                      device="cpu")
    assert s13.cfg.orb.scale_factor == 1.3

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
