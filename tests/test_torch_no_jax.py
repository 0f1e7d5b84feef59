"""The port and chip_smoke.py import nothing of JAX or the JAX package,
and the port never falls back to the CPU on its own."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys
    import numpy as np

    BLOCKED = ("jax", "jaxlib", "send_slam_tpu")

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
    from send_slam_tpu_torch.models.system import System, slice_config
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        System(slice_config(EngineConfig()))


def test_system_refuses_unported_features():
    """Only loop closing, BA windows over 64 keyframes and other
    pyramid scales are refused; the rest of the default tracking
    configuration constructs."""
    import dataclasses
    from send_slam_tpu_torch.config import EngineConfig, MapConfig, OrbConfig
    from send_slam_tpu_torch.models.system import System, slice_config
    with pytest.raises(NotImplementedError, match="loop closing"):
        System(EngineConfig(), device="cpu")
    cfg = slice_config(EngineConfig())
    ref = EngineConfig().tracking
    assert cfg.tracking == dataclasses.replace(
        ref, loop_min_gap_kf=cfg.map.max_keyframes)
    for field in ("init_collapse_frac", "init_backfill", "young_ba_at_kf",
                  "wide_ba_every_kf", "max_atlas_maps"):
        assert getattr(cfg.tracking, field) == getattr(ref, field)
    System(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="chunked BA"):
        System(cfg.replace(map=MapConfig(ba_window=65)), device="cpu")
    with pytest.raises(NotImplementedError, match="scale_factor"):
        System(cfg.replace(orb=OrbConfig(scale_factor=1.3)), device="cpu")
