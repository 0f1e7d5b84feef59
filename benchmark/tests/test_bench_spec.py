"""BENCHMARK.json against the contract's form, the harness finding its
files by name, and what it imports."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_helpers import BENCH, ROOT
from harness import spans
from harness.spec import Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "send_slam_tpu"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_names_units_and_text(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert TEXT.match(e[k]), e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            if "layer" in e:
                assert TEXT.match(e["layer"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(set(metric_names)) == len(metric_names)
    for word in bench["command"]:
        assert TEXT.match(word)


def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        cell = Cell(w["name"])
        e2e = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics("per_layer")
        for m in cell.metrics("per_layer"):
            moved = {e["name"]: e for e in bench["end_to_end"]}[m["moves"]]
            assert "workloads" not in moved or w["name"] in moved["workloads"]
        for kind in ("end_to_end", "per_layer"):
            for m in cell.metrics(kind):
                assert callable(cell.reader(m))
        driver = cell.driver()
        assert callable(driver.generate)
        assert isinstance(driver.SITES, dict) and isinstance(driver.SPANS, dict)
        for attr in ("setup", "step", "images", "finish"):
            assert callable(getattr(driver.Driver, attr))
        _check_files(cell)
        if w["config"] == "tum_fr1_mono":
            assert set(cell.config["limits"]) == {
                "frontend_mismatch_pct", "match_mismatch_pct", "pose_gap_px",
                "ba_gap_px", "tri_gap_rel"}


def _check_files(cell):
    """Each key of the configuration's limits names a loadable check file
    with what the comparison needs, and a control, if any, it can call;
    the driver's sites and spans, and every span the cell installs, are
    given in the form the harness reads."""
    assert cell.config["limits"]
    for name in cell.config["limits"]:
        assert NAME.match(name) and \
            (cell.bench_dir / "checks" / f"{name}.py").is_file(), name
    for name, chk in cell.checks().items():
        assert NAME.match(chk.STAGE) and chk.SAMPLE > 0, name
        assert all(len(tuple(s)) == 2 for s in chk.SITES), name
        assert callable(chk.keep) and callable(chk.value), name
        assert callable(getattr(chk, "CONTROL", callable)), name
    driver = cell.driver()
    for group in (driver.SITES, driver.SPANS):
        assert isinstance(group, dict)
        assert all(len(tuple(t)) == 2 for ts in group.values() for t in ts)
    for name in cell.spans():
        assert (cell.bench_dir / "spans" / f"{name}.json").is_file()


TOY_PROGRAM = """
def work(k):
    return 0.1 * k
"""

TOY_DRIVER = """
import time

import numpy as np

import toy_program
from send_slam_tpu_torch.utils import profiling

# The toy program's one stage, looked up in its own namespace, and timed
# under the tracking span beside the System's track_frame.
SITES = {"toy": [("toy_program", "work")]}
SPANS = {"tracking": [("toy_program", "work")]}


def generate(traffic, config, workers):
    return dict(lanes=int(traffic["lanes"]))


class Driver:
    def __init__(self, engine_cfg, recording, device):
        self.lanes = recording["lanes"]
        self.k = 0

    def setup(self):
        pass

    def step(self):
        with profiling.span("slam.toy", self.k):
            profiling.count("sync.toy", 3)
            toy_program.work(self.k)
        time.sleep(1e-3)
        self.k += 1
        return self.lanes, True

    def images(self, k):
        return [np.zeros((120, 160), np.uint8)] * self.lanes

    def finish(self):
        # Lane 0 streams the true centres; each later lane is off by a
        # height that alternates with the frame.
        true = [np.array([0.1 * k, 0.02 * (k % 7), 0.0])
                for k in range(self.k)]
        lanes = [dict(trajectory=[
            (k, c + np.array([0.0, 0.0, 0.01 * i * (-1) ** k]))
            for k, c in enumerate(true)], centres=true)
            for i in range(self.lanes)]
        return dict(landmarks=0, keyframes=0, lanes=lanes)
"""

TOY_CHECK = """
STAGE = "toy"
SAMPLE = 4
SITES = []


def keep(args, kwargs, out):
    return (args[0], out)


def value(items, config):
    return float(len(items))
"""

# A sixth kind of number, with a control of its own: the stage in
# float32, one step below the float64 it is compared against.
TOY_GAP = """
import numpy as np

STAGE = "toy"
SAMPLE = 4
SITES = []


def keep(args, kwargs, out):
    return (args[0], out)


def value(items, config):
    return max(abs(out - 0.1 * k) for k, out in items) if items else None


def work_f32(k):
    return float(np.float32(0.1) * np.float32(k))


def CONTROL(patch):
    import toy_program
    patch(toy_program, "work", work_f32)
"""


def _copy_bench(tmp_path):
    """The benchmark copied under ``tmp_path``; its BENCHMARK.json and
    the camera configuration, as dicts."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "tum_fr1_mono.json").read_text())
    return bench, cfg


def _add_toy(tmp_path, monkeypatch, bench, cfg):
    """A second driver with its own recording, sites, spans and two
    lanes, two checks that its configuration's limits name (one with a
    control), and readers of the program's spans and counters: new files
    and entries only. Returns the toy cell."""
    (tmp_path / "toy_program.py").write_text(TOY_PROGRAM)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "toy_program", raising=False)
    (tmp_path / "benchmark/drivers/toy.py").write_text(TOY_DRIVER)
    (tmp_path / "benchmark/checks/toy_calls.py").write_text(TOY_CHECK)
    (tmp_path / "benchmark/checks/toy_gap.py").write_text(TOY_GAP)
    (tmp_path / "benchmark/traffic/toy.json").write_text('{"lanes": 2}')
    toy = dict(cfg, driver="toy", limits={"toy_calls": 4, "toy_gap": 1e-12})
    (tmp_path / "benchmark/configs/toy_rig.json").write_text(json.dumps(toy))
    (tmp_path / "benchmark/metrics/toy.spans.py").write_text(
        "def read(run):\n    return len([s for s in run.program_spans"
        " if s[0] == 'slam.toy'])\n")
    (tmp_path / "benchmark/metrics/toy.syncs.py").write_text(
        "def read(run):\n    return run.counters.get('sync.toy')\n")
    bench["configs"].append(dict(name="toy_rig", source="x",
                                 file="benchmark/configs/toy_rig.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="toy_rig.lanes", config="toy_rig",
                                   traffic="toy", chips=1, why="a test"))
    for name in ("toy.spans", "toy.syncs"):
        bench["per_layer"].append(dict(
            name=name, unit="count", better="lower",
            source="program_counter", layer="toy", moves="device_ms_per_frame",
            workloads=["toy_rig.lanes"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell("toy_rig.lanes", tmp_path)
    _check_files(cell)
    return cell


def test_new_files_are_picked_up_without_a_code_edit(tmp_path,
                                                      monkeypatch):
    import run
    bench, cfg = _copy_bench(tmp_path)
    cam = json.loads(json.dumps(cfg))
    cam["engine"]["orb"]["n_features"] = 1200
    (tmp_path / "benchmark/configs/other_cam.json").write_text(json.dumps(cam))
    traffic = json.loads((BENCH / "traffic" / "steady.json").read_text())
    traffic["path_scale"] = 2.5
    (tmp_path / "benchmark/traffic/explore.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/metrics/calls.count.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    (tmp_path / "benchmark/metrics/lanes.ms_per_frame.py").write_text(
        "SPANS = ('lanes',)\n\n\ndef read(run):\n"
        "    return sum(run.span_ms('lanes')) or None\n")
    bench["configs"].append(dict(name="other_cam", source="x",
                                 file="benchmark/configs/other_cam.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="other_cam.explore",
                                   config="other_cam", traffic="explore",
                                   chips=1, why="a test"))
    bench["per_layer"].append(dict(name="calls.count", unit="calls",
                                   better="higher", source="host_clock",
                                   layer="device", moves="device_ms_per_frame",
                                   workloads=["other_cam.explore"]))
    bench["per_layer"].append(dict(name="lanes.ms_per_frame", unit="ms",
                                   better="lower", source="program_span",
                                   layer="lanes", moves="device_ms_per_frame",
                                   workloads=["other_cam.explore"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/spans/lanes.json").write_text(json.dumps(
        {"targets": [["send_slam_tpu_torch.parallel.multicam",
                      "multicam_slam_step"]]}))

    cell = Cell("other_cam.explore", tmp_path)
    assert cell.config["engine"]["orb"]["n_features"] == 1200
    assert cell.traffic["path_scale"] == 2.5
    names = [m["name"] for m in cell.metrics("per_layer")]
    assert "calls.count" in names
    reader = cell.reader(cell.metrics("per_layer")[names.index("calls.count")])

    class R:
        calls = [(0, 1)] * 7
    assert reader(R) == 7
    old = Cell("tum_fr1.steady", tmp_path)
    assert "calls.count" not in [m["name"] for m in old.metrics("per_layer")]
    # The new span is installed in the new cell's traced run only.
    assert "lanes" in cell.spans() and "lanes" not in old.spans()
    loaded = dict(spans.load(tmp_path / "benchmark/spans", cell.spans(),
                             {}))
    assert loaded["lanes"] == [("send_slam_tpu_torch.parallel.multicam",
                                "multicam_slam_step")]
    assert ("send_slam_tpu_torch.models.system", "track_frame") in \
        loaded["tracking"]
    # The camera driver adds no span target: its cell times what it did.
    assert old.driver().SPANS == {}

    # Then a whole traced run of the toy rig.
    cell = _add_toy(tmp_path, monkeypatch, bench, cfg)
    assert cell.driver().SITES == {"toy": [("toy_program", "work")]}
    assert list(cell.checks()) == ["toy_calls", "toy_gap"]
    # The driver's target joins the tracking span's own, after them.
    loaded = dict(spans.load(tmp_path / "benchmark/spans", cell.spans(),
                             cell.driver().SPANS))
    assert loaded["tracking"][-1] == ("toy_program", "work")
    assert ("send_slam_tpu_torch.models.system", "track_frame") in \
        loaded["tracking"]
    res, lines = run.run_cell(cell, 5, 6.0, True, device="cpu", workers=0)
    # The toy stage's sample is full: the driver's site was sampled.
    assert res["checks"] == {"toy_calls": dict(value=4.0, limit=4),
                             "toy_gap": dict(value=0.0, limit=1e-12)}
    assert res["correct"], lines
    # Two camera frames a call: the profiler window's 40 frames are 20
    # calls, each with one span and three named syncs.
    assert res["metrics"]["toy.spans"]["value"] == 20
    assert res["metrics"]["toy.syncs"]["value"] == 60
    # The tracking span timed the driver's target (the toy calls no
    # track_frame); the front end's, which the driver adds to, read none.
    assert res["metrics"]["tracking.ms_per_frame"]["value"] > 0
    assert "frontend.ms_per_frame" not in res["metrics"]
    assert res["attempted"] == 2 * res["info"]["calls"]
    # Every lane's poses count; the run's ATE is the worst lane's, each
    # lane aligned on its own.
    assert res["info"]["posed_frames"] == res["attempted"]
    assert res["failed"] == 0
    lane0, lane1 = res["info"]["lane_ate_m"]
    assert lane0 == pytest.approx(0.0, abs=1e-9)
    assert lane1 > 1e-3 and res["info"]["ate_m"] == lane1
    from send_slam_tpu_torch.utils import profiling
    assert not profiling.tracing()


def test_a_check_brings_its_control_as_a_file(tmp_path, monkeypatch):
    """The toy rig's ``toy_gap`` fails under ``control.on`` and only
    there; ``control.on`` plants no check's control but the cell's."""
    import control
    import run
    from send_slam_tpu_torch.ops import orb
    cell = _add_toy(tmp_path, monkeypatch, *_copy_bench(tmp_path))
    import toy_program
    work, pyramid = toy_program.work, orb.build_pyramid
    with control.on(cell):
        assert toy_program.work is not work
        assert orb.build_pyramid is pyramid
        res, lines = run.run_cell(cell, 6, 2.0, False, device="cpu",
                                  workers=0)
    assert toy_program.work is work
    assert not res["correct"]
    assert res["checks"]["toy_gap"]["value"] > 1e-9
    assert res["checks"]["toy_calls"] == dict(value=4.0, limit=4)
    assert "check toy_gap" in lines[-1]
    res, lines = run.run_cell(cell, 6, 2.0, False, device="cpu", workers=0)
    assert res["correct"], lines
    assert res["checks"]["toy_gap"]["value"] == 0.0


def _code_words(path):
    """The identifiers a file's code uses and the words of its strings,
    docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, ast.keyword) and node.arg:
            yield node.arg
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield from re.findall(r"[A-Za-z0-9_]+", node.value)


def test_the_code_names_no_driver_stage_or_check():
    """Drivers, checks and stages are found by the names the files give:
    the harness's code names none of them."""
    from bench_helpers import check
    drivers = {p.stem for p in (BENCH / "drivers").glob("*.py")}
    checks = {p.stem for p in (BENCH / "checks").glob("*.py")}
    stages = {check(c).STAGE for c in checks}
    assert drivers and checks and stages
    for f in ("run.py", "control.py", "harness/capture.py",
              "harness/correct.py", "harness/spans.py"):
        text = (BENCH / f).read_text()
        for name in checks:
            assert name not in text, (f, name)
        found = set(_code_words(BENCH / f)) & (drivers | stages | checks)
        assert not found, (f, found)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] in {"__future__", "functools", "typing",
                                         "numpy", "reference"}, (f, mod)


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or send_slam_tpu (compared
    whole: send_slam_tpu_torch is the program)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, control\n"
        "from harness import capture, correct, program, spans, trace,"
        " traffic, peaks\n"
        "from harness.spec import Cell\n"
        "c = Cell('tum_fr1.steady')\n"
        "c.driver(), c.checks(), program.tracer()\n"
        "[c.reader(m) for k in ('end_to_end', 'per_layer')"
        " for m in c.metrics(k)]\n"
        "print(','.join(run.forbidden_modules()))\n"
        "print('send_slam_tpu_torch' in sys.modules)\n") % (str(BENCH),
                                                           str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    found, port = out.stdout.rstrip("\n").split("\n")[-2:]
    assert found == "" and port == "True"


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "send_slam_tpu_torch_x", object())
    assert "send_slam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "send_slam_tpu.models", object())
    assert run.forbidden_modules() == ["send_slam_tpu"]


RUN = ["benchmark/run.py", "--workload", "tum_fr1.steady", "--seed",
       "3000000000", "--seconds", "1", "--trace", "0"]


def test_without_a_card_the_run_prints_nothing():
    out = subprocess.run([sys.executable] + RUN, capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_alone_in_a_directory_the_run_prints_nothing(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable] + RUN, capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
