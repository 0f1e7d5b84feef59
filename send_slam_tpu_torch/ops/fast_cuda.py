"""Build and bind the hand-written CUDA FAST-16 kernel (csrc/fast_kernel.cu).

The source is compiled at first use with plain ``nvcc`` into a shared
library with a C interface (no PyTorch headers: a few seconds), keyed by
a hash of the source, under ``send_slam_tpu_torch/_build/`` (git-ignored),
and loaded with ``ctypes``. Nothing is built or loaded at import time.

``launches`` counts kernel launches made through :func:`fast_score_cuda`;
callers that want to show a run went through the kernel reset it to 0
and read it back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fast_kernel.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

launches = 0          # kernel launches through fast_score_cuda
build_seconds = None  # wall time of the nvcc build in this process

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA FAST kernel cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"fast_kernel_{digest}.so"


def build() -> Path:
    """Compile the kernel if its library is missing; return its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed on %s:\n%s%s" % (
            SOURCE, proc.stdout, proc.stderr))
    os.replace(tmp, out)            # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """Build (if needed) and load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fast_score.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p]
            lib.fast_score.restype = ctypes.c_int
            _lib = lib
    return _lib


def fast_score_cuda(img: torch.Tensor, threshold: float,
                    with_nms: bool = False):
    """FAST score of (H, W) or (B, H, W) float32 CUDA images.

    Returns the raw score map, or (raw, nms) with ``with_nms``; both in
    the input's shape. Launches on the current stream, never syncs."""
    global launches
    if not img.is_cuda:
        raise ValueError("fast_score_cuda needs a CUDA tensor")
    if img.dtype != torch.float32:
        raise TypeError(f"fast_score_cuda needs float32, got {img.dtype}")
    if img.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("fast_score_cuda needs a contiguous tensor")
    B = 1 if img.dim() == 2 else img.shape[0]
    H, W = img.shape[-2], img.shape[-1]
    if B == 0 or H == 0 or W == 0:
        raise ValueError(f"empty image batch {tuple(img.shape)}")
    lib = load()
    raw = torch.empty_like(img)
    nms = torch.empty_like(img) if with_nms else None
    stream = torch.cuda.current_stream(img.device).cuda_stream
    with torch.cuda.device(img.device):
        err = lib.fast_score(img.data_ptr(), raw.data_ptr(),
                             nms.data_ptr() if with_nms else None,
                             B, H, W, float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"fast_score kernel launch failed: CUDA error {err}")
    launches += 1
    return (raw, nms) if with_nms else raw
