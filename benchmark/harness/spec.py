"""The benchmark's files, found by the names ``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the entry's ``file``): the deployment as
  run: the engine's configuration, its ``driver`` and the comparison's
  ``limits``;
- ``drivers/<driver>.py``: how the deployment is driven: its recording,
  ``generate(traffic, config, workers)``; ``Driver(engine_cfg,
  recording, device)`` with ``setup()``, ``step()`` (camera frames
  handed over, whether the call returned a pose), ``images(k)`` (what
  call k handed over) and ``finish()`` (the map's fill, and ``lanes``:
  per lane, its streamed trajectory and the true centres of its frames,
  {trajectory, centres}); ``SITES``, the comparison's sites it adds to a
  stage, and ``SPANS``, the targets it adds to a span;
- ``traffic/<traffic>.json``: the parameters of the driver's generator;
- ``checks/<number>.py``, one per key of the configuration's ``limits``:
  a number the comparison judges (``harness/capture.py``,
  ``harness/correct.py``), and, optionally, its stage's control
  (``CONTROL``, ``control.py``);
- ``metrics/<metric>.py``: a reader ``read(run)`` per metric, end to end
  or per layer, returning a number or None, and the spans it reads
  (``SPANS``, a tuple of names; none when left out);
- ``spans/<span>.json``: the program functions a span times.

No list of names sits in code: a new configuration, driver, traffic
mix, check (with its control), metric or span is a new file and a new
entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.bench_dir = root / "benchmark"
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        entry = {c["name"]: c for c in self.bench["configs"]}[
            self.workload["config"]]
        self.config: Dict = json.loads((root / entry["file"]).read_text())
        self.traffic: Dict = json.loads(
            (self.bench_dir / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self._modules: Dict = {}

    def driver(self):
        """The configuration's driver module."""
        return self._load("drivers", self.config["driver"])

    def checks(self) -> Dict:
        """{number: check module} for each key of the ``limits``."""
        return {k: self._load("checks", k) for k in self.config["limits"]}

    def metrics(self, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: Dict):
        return self._reader_module(metric).read

    def spans(self) -> List[str]:
        """The spans the cell's per-layer readers read."""
        return sorted({s for m in self.metrics("per_layer")
                       for s in getattr(self._reader_module(m), "SPANS", ())})

    def _reader_module(self, metric: Dict):
        return self._load("metrics", metric["name"])

    def _load(self, kind: str, name: str):
        """``<kind>/<name>.py``, loaded once per cell."""
        if (kind, name) not in self._modules:
            self._modules[kind, name] = load_module(
                self.bench_dir / kind / f"{name}.py",
                f"bench_{kind}_" + name.replace(".", "_").replace("-", "_"))
        return self._modules[kind, name]
