"""Build and bind the hand-written CUDA pose Gauss-Newton kernel
(csrc/pose_gn_kernel.cu): one launch runs a whole robust pose-only
Gauss-Newton (``models/tracking.py`` ``pose_only_gn``), every round and
iteration on the card.

Built, loaded and launched through ``ops/cuda_build.py``; nothing is
built or loaded at import time. ``LIBRARY.launches`` is the launch
count.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from send_slam_tpu_torch.ops.cuda_build import (
    CSRC, CudaLibrary, cuda_device, tensor_ptr,
)

SOURCE = CSRC / "pose_gn_kernel.cu"


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pose_gn.argtypes = [i, i, i, p, p, p, p, p, p, p, f, f, f, f, f,
                            p, p, p]
    lib.pose_gn.restype = ctypes.c_int


LIBRARY = CudaLibrary("pose_gn", SOURCE, [], _bind)


def _check(x, name, shape, dtype, dev):
    return tensor_ptr("pose_gn_cuda", x, name, shape, dtype, dev)


def _intrinsics(fx, fy, cx, cy, dev):
    """Python numbers by value; else four 0-dim float32 tensors on X's
    device, stacked into one device array the kernel reads."""
    cam = (fx, fy, cx, cy)
    if all(isinstance(c, numbers.Real) for c in cam):
        return [float(c) for c in cam], None
    for name, c in zip(("fx", "fy", "cx", "cy"), cam):
        _check(c, name, (), torch.float32, dev)
    return [0.0] * 4, torch.stack(cam)


def pose_gn_cuda(R0, t0, X, uv_obs, w_valid, fx, fy, cx, cy, sigma2=None,
                 rounds: int = 4, iters: int = 10,
                 huber_delta: float = 2.447):
    """One launch of the robust pose-only Gauss-Newton. Inputs as
    ``pose_only_gn`` takes them: contiguous float32 CUDA tensors on one
    device (``w_valid`` bool); the intrinsics Python numbers or 0-dim
    float32 tensors there. Returns (R (3, 3), t (3,), inlier (N,) bool,
    chi2 () float32, n_inliers () int32); R, t, chi2 and n_inliers are
    views into one buffer. Launches on the current stream, never
    syncs."""
    dev = cuda_device("pose_gn_cuda", X)
    n = X.shape[0]
    ptrs = [_check(R0, "R0", (3, 3), torch.float32, dev),
            _check(t0, "t0", (3,), torch.float32, dev),
            _check(X, "X", (n, 3), torch.float32, dev),
            _check(uv_obs, "uv_obs", (n, 2), torch.float32, dev),
            _check(w_valid, "w_valid", (n,), torch.bool, dev),
            None if sigma2 is None
            else _check(sigma2, "sigma2", (n,), torch.float32, dev)]
    cam, cam_dev = _intrinsics(fx, fy, cx, cy, dev)
    if rounds < 0 or iters < 0:
        raise ValueError(f"rounds and iters must be >= 0, got {rounds}, "
                         f"{iters}")
    out = torch.empty(16, dtype=torch.float32, device=dev)
    inlier = torch.empty(n, dtype=torch.bool, device=dev)
    LIBRARY.launch("pose_gn", dev, n, int(rounds), int(iters), *ptrs,
                   None if cam_dev is None else cam_dev.data_ptr(), *cam,
                   float(huber_delta), out.data_ptr(),
                   inlier.data_ptr() if n else None)
    return (out[:9].view(3, 3), out[9:12], inlier, out[12],
            out[13:14].view(torch.int32)[0])
