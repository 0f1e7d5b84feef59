"""The comparison's control: the program one precision step below the
float32 its configuration states, which ``correct`` has to refuse.

- Matrix products and convolutions run in TF32 (the port's own precision
  switch, ``send_slam_tpu_torch/device.py``, turned the other way).
- Each check of the cell (``checks/<number>.py``) may bring, as
  ``CONTROL(patch)``, its stage's step below float32 where a switch does
  not reach it: it calls ``patch(owner, attribute, value)`` to put that
  version in the program's place, at the name the program's own module
  looks it up by, so that every path that calls the stage meets it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        --seconds <s> [--sound]

runs the cell once per seed in one process, with the control on (or
with ``--sound``, as the program is) and prints one JSON line per run:
the numbers compared, their limits and ``correct``. The benchmark's own
runs never turn the control on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

import torch


@contextlib.contextmanager
def on(cell):
    """The control of ``cell`` (a ``harness.spec.Cell``), on for the body
    of the ``with``: TF32, and the ``CONTROL`` of each of its checks."""
    from send_slam_tpu_torch import device
    device.set_full_precision()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    stack = contextlib.ExitStack()

    def patch(owner, attr, value):
        stack.enter_context(mock.patch.object(owner, attr, value))

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        for chk in cell.checks().values():
            if hasattr(chk, "CONTROL"):
                chk.CONTROL(patch)
        yield
    finally:
        stack.close()
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
        torch.set_float32_matmul_precision(flags[2])


def main(argv=None) -> int:
    import run
    from harness.spec import Cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        cell = Cell(args.workload)
        with (contextlib.nullcontext() if args.sound else on(cell)):
            res, _ = run.run_cell(cell, seed, args.seconds, False)
        print(json.dumps(dict(
            workload=args.workload, seed=seed,
            control=not args.sound, correct=res["correct"],
            checks=res["checks"], metrics=res["metrics"], info=res["info"])),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
