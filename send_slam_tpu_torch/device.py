"""Device choice and float32 precision for the whole port.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a
card, asking for CUDA raises: the port never falls back to the CPU on
its own. The CPU runs only when the caller says ``device="cpu"``, as the
tests do.

Precision is pinned once, here: float32 matrix products and
convolutions in full float32, never TF32. TF32 keeps ~10 mantissa bits,
the Hopper counterpart of the TPU's bf16 truncation that the JAX package
turns off with ``jax_default_matmul_precision="highest"``; geometry
(projections, Gauss-Newton normal equations, triangulation) needs f32.
"""

from __future__ import annotations

import torch

_PRECISION_SET = False


def set_full_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (idempotent)."""
    global _PRECISION_SET
    if _PRECISION_SET:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _PRECISION_SET = True


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the card (raises without one);
    ``"cpu"`` -> the CPU. Also pins full float32 precision."""
    set_full_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "send_slam_tpu_torch: CUDA was requested (the default) but no "
            "CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
