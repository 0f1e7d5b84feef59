"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs CUDA cards, as many as the cell asks for; without them it exits
non-zero and prints no result. The configuration's driver
(``drivers/<driver>.py``) makes the cell's recording from its traffic
file, sets the engine up and warms it (``setup_s``), then drives it
closed loop for ``--seconds``: the next call goes in when the one before
returns. ``--trace 0`` reports the cell's end-to-end metrics, recording
the card's activity over the whole window where one of them reads the
device (``harness/devclock.py``); ``--trace 1`` times the layers with synchronised spans over the first 60% of the
window and reads one ``torch.profiler`` window over the steady frames
after it, with the program's own tracer on, and reports the per-layer
metrics, the device's busy time and a breakdown. Either way the sampled
outputs of the timed stages are compared with the plain reference once
the window has closed (``checks/``, ``harness/correct.py``); the numbers
compared end standard error and the result line. The last line of
standard output is one JSON object.
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
    """EngineConfig from the configuration file's ``engine`` group: each
    group given sets its fields, the rest keep the engine's defaults."""
    import dataclasses
    from send_slam_tpu_torch import config as C

    def build(cls, vals):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in vals:
                continue
            v = vals[f.name]
            if dataclasses.is_dataclass(f.default):
                v = build(type(f.default), v)
            kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)

    return build(C.EngineConfig, d)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _fast_bound(drv, calls, cfg_orb):
    """Mean least time per FAST launch over a sample of the profiler
    window's calls, on the images they handed over (one launch a call,
    over all of its images)."""
    from harness.peaks import fast_bound_ms
    from reference.frontend import fast_counts
    if not calls:
        return None
    pick = [calls[int(i * len(calls) / FAST_SAMPLE)]
            for i in range(min(FAST_SAMPLE, len(calls)))]
    bounds = []
    for k in pick:
        counts = [fast_counts(img, cfg_orb) for img in drv.images(k)]
        bounds.append(fast_bound_ms(*(sum(c) for c in zip(*counts))))
    return sum(bounds) / len(bounds)


def _ate(traj, centres):
    """Sim(3)-aligned RMSE (m) of the streamed positions, (session frame,
    position) pairs, against the true centres of those frames."""
    import numpy as np
    if len(traj) < 3:
        return None
    e = np.array([p for _, p in traj], np.float64)
    g = np.array(centres, np.float64)
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


def _host_clock(run):
    """The window on the host's clock, for the record: camera frames per
    second and the 95th percentile of the calls' ms."""
    import numpy as np
    if not run.calls or run.window_s <= 0:
        return None
    ms = [(e - s) * 1e3 for s, e in run.calls]
    return dict(frames_per_s=run.frames() / run.window_s,
                frame_ms_p95=float(np.percentile(ms, 95)))


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None,
             workers=None):
    """One run of ``cell`` (a ``harness.spec.Cell``). Returns the result
    dict (its "checks" last) and the list of lines for standard error."""
    import torch

    from harness import capture, correct, devclock, program
    from harness import spans as spans_mod
    from harness import trace as trace_mod
    from harness.record import Run
    from harness.traffic import render_workers

    t_start = time.perf_counter() if t_start is None else t_start
    t_entry = time.perf_counter()
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.set_num_threads(THREADS)

    driver = cell.driver()
    checks = cell.checks()
    t0 = time.perf_counter()
    recording = driver.generate(
        cell.traffic, cell.config,
        render_workers() if workers is None else workers)
    render_s = time.perf_counter() - t0

    cfg = engine_config(cell.config["engine"])
    drv = driver.Driver(cfg, recording, device)
    t_setup = time.perf_counter()
    drv.setup()
    t_setup = time.perf_counter() - t_setup
    stash = capture.stash(seed, checks, driver.SITES)
    stash.install()
    # An untraced run whose end-to-end metrics read the device records the
    # card's activity over the whole window (built here, as set-up).
    clock = devclock.DeviceClock(sync) if cuda and not trace and any(
        m["source"] == "device_trace"
        for m in cell.metrics("end_to_end")) else None
    sync()
    setup_s = time.perf_counter() - t_start - render_s

    span = spans_mod.Spans(spans_mod.load(cell.bench_dir / "spans",
                                          cell.spans(), driver.SPANS),
                           sync=sync) if trace else None
    if span is not None:
        span.install()
    tracer = program.tracer() if trace else None
    prof, prof_calls, summary, recorded = None, [], None, None
    calls, call_frames, first_pose, span_frames = [], [], None, 0
    device = None
    if clock is not None:
        clock.start()
    w0, w0_ns = time.perf_counter(), time.time_ns()

    def stop_window():
        # The program's spans and counters over the profiler window, on
        # the window's clock (its stamps are time.time_ns()).
        if tracer is not None:
            tracer.set_tracing(False)
        out = prof.stop()
        if tracer is None:
            return out, None
        got = tracer.drain()
        return out, ([(n, f, (s - w0_ns) * 1e-9, (e - w0_ns) * 1e-9)
                      for n, f, _, s, e in got.spans], dict(got.counts))

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
                if tracer is not None:
                    tracer.drain()
                    tracer.set_tracing(True)
            n, posed = drv.step()
            c1 = time.perf_counter() - w0
            k = len(calls)
            calls.append((c0, c1))
            call_frames.append(n)
            if posed and first_pose is None:
                first_pose = c1
            if prof is not None:
                prof.frames += n
                prof_calls.append(k)
                if prof.frames >= PROFILE_FRAMES:
                    summary, recorded = stop_window()
                    prof = None
            elif span is not None and summary is None:
                span_frames += n
        if prof is not None:
            summary, recorded = stop_window()
        if clock is not None:
            device = clock.stop()
    finally:
        if clock is not None:
            clock.stop()
        if tracer is not None:
            tracer.set_tracing(False)
        if span is not None:
            span.uninstall()
        stash.uninstall()
    window_s = calls[-1][1]
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    fin = drv.finish()
    lanes = fin["lanes"]
    posed = sum(len(ln["trajectory"]) for ln in lanes)
    # Each lane aligned on its own: lanes keep their own gauge until a
    # merge. The worst lane's ATE is the run's.
    lane_ate = [_ate(ln["trajectory"], ln["centres"]) for ln in lanes]

    run = Run(setup_s=setup_s, calls=calls, call_frames=call_frames,
              window_s=window_s, first_pose_s=first_pose, device=device)
    if span is not None:
        run.spans = [(n, t, s - w0, e - w0) for n, t, s, e in span.records]
        run.span_frames = span_frames
        run.trace = summary
        if summary is not None:
            run.fast_bound_ms = _fast_bound(drv, prof_calls,
                                            cell.config["engine"]["orb"])
        if recorded is not None:
            run.program_spans, run.counters = recorded
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
    values = correct.compare(stash, checks, cell.config)
    t_ref = time.perf_counter() - t_ref
    ok, judged = correct.judge(values, cell.config["limits"])
    lines = []
    if first_pose is None:
        ok = False
        lines.append("no pose reached the host in the window")
    info = dict(first_pose_s=first_pose, render_s=render_s,
                reference_s=t_ref, calls=len(calls),
                host=_host_clock(run), device_window=device,
                setup_parts=dict(start_to_run=t_entry - t_start,
                                 driver_setup=t_setup),
                ate_m=max((a for a in lane_ate if a is not None),
                          default=None),
                lane_ate_m=lane_ate, posed_frames=posed,
                landmarks=fin["landmarks"], keyframes=fin["keyframes"],
                **correct.info(stash, checks))
    attempted = run.frames()
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
    result["checks"] = judged
    lines += [f"check {k}: {c['value']} (limit {c['limit']})"
              for k, c in judged.items()]
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
