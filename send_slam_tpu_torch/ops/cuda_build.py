"""Build and load one hand-written CUDA source of ``csrc/`` as a shared
library with a plain C interface.

The source is compiled at first use with plain ``nvcc`` (no PyTorch
headers: a few seconds), keyed by a hash of the source and the flags,
under ``send_slam_tpu_torch/_build/`` (git-ignored), and loaded with
``ctypes``. Nothing is built or loaded at import time. ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
the library (:meth:`CudaLibrary.ptxas_report`).
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
from typing import Callable, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# sm_90a: the H100; -Xptxas -v for the report kept beside the library.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def tensor_ptr(owner: str, x, name: str, shape, dtype, dev) -> int:
    """``x``'s data pointer, once it is a contiguous ``dtype`` tensor of
    ``shape`` on ``dev``; else a TypeError or ValueError naming ``owner``
    (the wrapper) and ``name`` (the argument)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{owner}: {name} must be a tensor")
    if x.device != dev:
        raise ValueError(f"{owner}: {name} lies on {x.device}, not {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{owner}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{owner}: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{owner}: {name} must be contiguous")
    return x.data_ptr()


class CudaLibrary:
    """One ``csrc/`` source, its build and its loaded library.

    ``bind`` declares the argument and result types of the library's C
    entry points on the ``ctypes.CDLL`` once, when it is loaded."""

    def __init__(self, source: Path, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.flags = list(flags)
        self._bind = bind
        self.build_seconds: Optional[float] = None  # nvcc wall time here
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()
                                ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}_{digest}.so"

    def ptxas_report(self) -> str:
        """nvcc's -Xptxas -v lines of the built library ('' before a
        build)."""
        log = self.path().with_suffix(".ptxas.txt")
        return log.read_text() if log.exists() else ""

    def build(self) -> Path:
        """Compile the source if its library is missing; return its
        path."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *self.flags, "-o", tmp, str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("nvcc failed on %s:\n%s%s" % (
                self.source, proc.stdout, proc.stderr))
        out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)            # atomic: concurrent builders agree
        self.build_seconds = time.perf_counter() - t0
        return out

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library once per process."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib
