"""The comparison's control: the program one precision step below the
float32 its configuration states, which ``correct`` has to refuse.

- Matrix products and convolutions run in TF32 (the port's own precision
  switch, ``send_slam_tpu_torch/device.py``, turned the other way): the
  projections and the normal equations of tracking among them. The
  robust pose Gauss-Newton, which the program runs on the card as one
  hand-written kernel that TF32 does not reach, is put in its place as
  its plain PyTorch version (``pose_only_gn_plain``), whose products it
  does reach.
- The front end runs no matrix product; its stages that a later change
  would be tempted to hand to cuDNN (the pyramid's resample and the
  blur, both convolutions) are put in the program's place computed as
  TF32 computes them: each operand of their multiply-adds rounded to 10
  mantissa bits.
- The new landmarks' triangulation, which the program forms and solves
  in float64, is put in its place in float32.
- Bundle adjustment's residual, weight and Jacobian planes, float32
  work that is no matrix product, are rounded to bfloat16 where they
  are produced, as a fused kernel with bfloat16 operands and float32
  sums would take them.

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

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

MANTISSA_TF32 = 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32's mantissa, to nearest even."""
    drop = 23 - MANTISSA_TF32
    b = x.contiguous().view(torch.int32)
    b = (b + ((1 << (drop - 1)) - 1) + ((b >> drop) & 1)) & ~((1 << drop) - 1)
    return b.view(torch.float32)


def _mul(w: float, x: torch.Tensor) -> torch.Tensor:
    wt = round_tf32(torch.tensor([w], dtype=torch.float32))[0].item()
    return wt * round_tf32(x)


def _down65(x: torch.Tensor, axis: int) -> torch.Tensor:
    from send_slam_tpu_torch.ops.pyramid import _PHASE
    x = x.movedim(axis, 0)
    q = x.shape[0] // 6
    g = x[: q * 6].reshape((q, 6) + tuple(x.shape[1:]))
    outs = [_mul(1.0 - w, g[:, o]) + _mul(w, g[:, o + 1]) for o, w in _PHASE]
    return torch.stack(outs, 1).reshape((q * 5,) + tuple(x.shape[1:])) \
        .movedim(0, axis)


def build_pyramid_tf32(img, n_levels, scale):
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(_down65(_down65(levels[-1], 0), 1))
    return levels


def gaussian_blur_tf32(img, sigma=2.0, ksize=7):
    from send_slam_tpu_torch.ops.pyramid import _gaussian_kernel1d
    k = _gaussian_kernel1d(sigma, ksize)
    pad = ksize // 2
    H, W = img.shape
    x = torch.nn.functional.pad(img[None, None], (pad,) * 4,
                                mode="reflect")[0, 0]
    acc = sum(_mul(float(k[i]), x[:, i:i + W]) for i in range(ksize))
    return sum(_mul(float(k[i]), acc[i:i + H, :]) for i in range(ksize))


def triangulate_batch_f32(P1, P2, x1, x2):
    """The linear triangulation's normal equations (the DLT rows with the
    point's fourth coordinate 1) formed and solved in float32."""
    P1, P2, x1, x2 = (v.float() for v in (P1, P2, x1, x2))
    rows = []
    for P, x in ((P1, x1), (P2, x2)):
        r2 = P[..., 2, :].unsqueeze(-2)
        rows.append(x[..., 0:1] * r2 - P[..., 0, :].unsqueeze(-2))
        rows.append(x[..., 1:2] * r2 - P[..., 1, :].unsqueeze(-2))
    A = torch.stack(torch.broadcast_tensors(*rows), -2)      # (N, 4, 4)
    M, b = A[..., :3], -A[..., 3]
    MtM = M.transpose(-1, -2) @ M
    Mtb = (M * b[..., None]).sum(-2)
    return torch.linalg.solve_ex(MtM, Mtb[..., None])[0][..., 0]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def obs_terms_bf16(orig):
    def terms(*a, **kw):
        *planes, pz = orig(*a, **kw)
        return tuple(_bf16(p) for p in planes) + (pz,)
    return terms


@contextlib.contextmanager
def on():
    """The control, on for the body of the ``with``."""
    from send_slam_tpu_torch import device
    from send_slam_tpu_torch.models import local_ba, local_mapping, tracking
    from send_slam_tpu_torch.ops import orb
    device.set_full_precision()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    saved = (orb.build_pyramid, orb.gaussian_blur,
             local_mapping.triangulate_batch, local_ba._obs_terms,
             tracking.pose_only_gn)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    orb.build_pyramid, orb.gaussian_blur = (build_pyramid_tf32,
                                            gaussian_blur_tf32)
    local_mapping.triangulate_batch = triangulate_batch_f32
    local_ba._obs_terms = obs_terms_bf16(saved[3])
    tracking.pose_only_gn = tracking.pose_only_gn_plain
    try:
        yield
    finally:
        (orb.build_pyramid, orb.gaussian_blur,
         local_mapping.triangulate_batch, local_ba._obs_terms,
         tracking.pose_only_gn) = saved
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
        with (contextlib.nullcontext() if args.sound else on()):
            res, _ = run.run_cell(Cell(args.workload), seed, args.seconds,
                                  False)
        print(json.dumps(dict(
            workload=args.workload, seed=seed,
            control=not args.sound, correct=res["correct"],
            checks=res["checks"], metrics=res["metrics"], info=res["info"])),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
