"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs CUDA cards, as many as the cell asks for; without them it exits
non-zero and prints no result. It renders the cell's traffic from the
seed, sets the engine up and warms it (``setup_s``), then drives it
closed loop for ``--seconds``: the next frame goes in when the call
returns. ``--trace 0`` reports the cell's end-to-end metrics; ``--trace
1`` times the layers with synchronised spans over the first 60% of the
window and reads one ``torch.profiler`` window over the steady frames
after it, and reports the per-layer metrics, the device's busy time and
a breakdown. Either way the sampled outputs of the timed stages are
compared with the plain reference once the window has closed
(``harness/correct.py``); the numbers compared end standard error and
the result line. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))
# Libraries the port uses must not pull JAX in on their own.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

SPAN_SHARE = 0.6          # traced run: spans over this share of the window
PROFILE_FRAMES = 40       # camera frames in the profiler window (at most)
FAST_SAMPLE = 8           # profiler-window calls whose FAST work is counted
FORBIDDEN = ("jax", "jaxlib", "flax", "send_slam_tpu")
THREADS = 1              # torch's host threads: one process, few threads


def engine_config(d):
    """EngineConfig from the configuration file's ``engine`` group."""
    import dataclasses
    from send_slam_tpu_torch import config as C

    def build(cls, vals):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in vals:
                v = vals[f.name]
                kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)

    return C.EngineConfig(
        orb=build(C.OrbConfig, d["orb"]), camera=build(C.CameraConfig,
                                                       d["camera"]),
        map=build(C.MapConfig, d["map"]),
        tracking=build(C.TrackingConfig, d["tracking"]),
        dtype=d.get("dtype", "float32"),
        image_dtype=d.get("image_dtype", "float32"))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _fast_bound(traffic, calls, cfg_orb):
    """Mean least time per FAST launch over a sample of the profiler
    window's calls, on the frames they handed over."""
    from harness.peaks import fast_bound_ms
    from reference.frontend import fast_counts
    if not calls:
        return None
    pick = [calls[int(i * len(calls) / FAST_SAMPLE)]
            for i in range(min(FAST_SAMPLE, len(calls)))]
    bounds = [fast_bound_ms(*fast_counts(traffic.frames[traffic.index(k)],
                                         cfg_orb)) for k in pick]
    return sum(bounds) / len(bounds)


def _ate(traj, traffic):
    """Sim(3)-aligned RMSE (m) of the streamed positions, (session frame,
    position) pairs, against the true centres."""
    import numpy as np
    if len(traj) < 3:
        return None
    e = np.array([p for _, p in traj], np.float64)
    g = np.array([traffic.centres[traffic.index(k)] for k, _ in traj])
    me, mg = e.mean(0), g.mean(0)
    xe, xg = e - me, g - mg
    U, D, Vt = np.linalg.svd(xg.T @ xe / len(e))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xe ** 2).sum() / len(e))
    al = s * xe @ R.T + mg
    return float(np.sqrt(((al - g) ** 2).sum(1).mean()))


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None,
             workers=None):
    """One run of ``cell`` (a ``harness.spec.Cell``). Returns the result
    dict (its "checks" last) and the list of lines for standard error."""
    import torch

    from harness import capture, correct, spans as spans_mod
    from harness import trace as trace_mod
    from harness.driver import Driver
    from harness.record import Run
    from harness.traffic import generate, render_workers

    t_start = time.perf_counter() if t_start is None else t_start
    t_entry = time.perf_counter()
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.set_num_threads(THREADS)

    t0 = time.perf_counter()
    traffic = generate(cell.traffic, cell.config,
                       render_workers() if workers is None else workers)
    render_s = time.perf_counter() - t0

    cfg = engine_config(cell.config["engine"])
    drv = Driver(cfg, traffic, device)
    t_setup = time.perf_counter()
    drv.setup()
    t_setup = time.perf_counter() - t_setup
    stash = capture.stash(seed)
    stash.install()
    sync()
    setup_s = time.perf_counter() - t_start - render_s

    span = spans_mod.Spans(spans_mod.load(cell.bench_dir / "spans",
                                          cell.spans()),
                           sync=sync) if trace else None
    if span is not None:
        span.install()
    prof, prof_calls, summary = None, [], None
    calls, first_pose, span_frames = [], None, 0
    w0 = time.perf_counter()
    try:
        while True:
            c0 = time.perf_counter() - w0
            if c0 >= seconds:
                break
            if span is not None and prof is None and summary is None \
                    and c0 >= SPAN_SHARE * seconds:
                span.uninstall()
                prof = trace_mod.Window(sync)
                prof.start()
            posed = drv.step()
            c1 = time.perf_counter() - w0
            k = len(calls)
            calls.append((c0, c1))
            if posed and first_pose is None:
                first_pose = c1
            if prof is not None:
                prof.frames += 1
                prof_calls.append(k)
                if prof.frames >= PROFILE_FRAMES:
                    summary = prof.stop()
                    prof = None
            elif span is not None and summary is None:
                span_frames += 1
        if prof is not None:
            summary = prof.stop()
    finally:
        stash.uninstall()
        if span is not None:
            span.uninstall()
    window_s = calls[-1][1]
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    fin = drv.finish()

    run = Run(setup_s=setup_s, calls=calls,
              window_s=window_s, first_pose_s=first_pose)
    if span is not None:
        run.spans = [(n, t, s - w0, e - w0) for n, t, s, e in span.records]
        run.span_frames = span_frames
        run.trace = summary
        if summary is not None:
            run.fast_bound_ms = _fast_bound(traffic, prof_calls,
                                            cell.config["engine"]["orb"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        v = cell.reader(m)(run)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])

    del drv
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values = correct.compare(stash, cell.config)
    t_ref = time.perf_counter() - t_ref
    ok, checks = correct.judge(values, cell.config["limits"])
    lines = []
    if first_pose is None:
        ok = False
        lines.append("no pose reached the host in the window")
    kept = stash.items("frontend")
    info = dict(first_pose_s=first_pose, render_s=render_s,
                reference_s=t_ref, calls=len(calls),
                setup_parts=dict(start_to_run=t_entry - t_start,
                                 driver_setup=t_setup),
                ate_m=_ate(fin["trajectory"], traffic),
                posed_frames=len(fin["trajectory"]),
                landmarks=fin["landmarks"], keyframes=fin["keyframes"],
                keypoints_per_frame=(sum(int(f.feat.valid.sum())
                                         for _, f in kept) / len(kept)
                                     if kept else None))
    attempted = run.frames()
    posed = len(fin["trajectory"])
    result = dict(correct=ok, attempted=attempted,
                  failed=max(attempted - posed, 0), metrics=metrics)
    if cuda:
        result["device"] = dict(
            platform="gpu", kind=torch.cuda.get_device_name(0),
            count=int(cell.workload["chips"]), memory_peak_bytes=memory_peak)
    else:
        result["device"] = dict(platform="cpu", kind="cpu", count=1,
                                memory_peak_bytes=0)
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = dict(
            device_ops=[[n, s] for n, s in summary["device_ops"]],
            idle_gaps=[[n, s] for n, s in summary["idle_gaps"]])
    result["info"] = info
    result["checks"] = checks
    lines += [f"check {k}: {c['value']} (limit {c['limit']})"
              for k, c in checks.items()]
    return result, lines


def _card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import Cell
    cell = Cell(args.workload)
    import torch
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: the cell needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print("benchmark: modules that must not load were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    result["info"]["card"] = _card_line()
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
