"""Shared set-up of the benchmark's tests: the import paths, and cells cut
to a size the CPU runs in seconds (the widths are the test's, not the
benchmark's: the benchmark's cells run only on the card)."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Cell, load_module  # noqa: E402


def check(name: str):
    """The check module ``checks/<name>.py``."""
    return load_module(BENCH / "checks" / f"{name}.py", "test_check_" + name)


def small_cell(name: str, width=320, height=240, features=500, levels=4,
               lap=120, root=ROOT) -> Cell:
    """``name`` as BENCHMARK.json defines it, at a CPU test's size: the
    camera scaled to ``width`` x ``height``, fewer features and levels,
    small map tables and a short lap."""
    cell = Cell(name, root)
    eng = cell.config["engine"]
    cam = eng["camera"]
    s = width / cam["width"]
    cam.update(width=width, height=height, fx=cam["fx"] * s, fy=cam["fy"] * s,
               cx=cam["cx"] * s, cy=cam["cy"] * s)
    eng["orb"].update(n_features=features, n_levels=levels)
    eng["map"].update(max_keyframes=32, max_landmarks=4096)
    cell.traffic["lap_frames"] = lap
    return cell


def run_small(cell, seed=20260917, seconds=30.0, trace=False, **kw):
    import run
    return run.run_cell(cell, seed, seconds, trace, device="cpu", workers=0,
                        **kw)
