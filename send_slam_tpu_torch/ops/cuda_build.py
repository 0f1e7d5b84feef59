"""Build, load and launch the port's native libraries.

Each library is one C++ or CUDA source compiled at first use into a
shared library with a plain C interface, keyed by a hash of the source
and the flags, under ``send_slam_tpu_torch/_build/`` (git-ignored), and
loaded with ``ctypes``. Nothing is built or loaded at import time. The
compiler's output is kept beside the library (:meth:`NativeLibrary.report`):
for ``nvcc``, its ``-Xptxas -v`` report (registers, shared memory,
spills).

:class:`NativeLibrary` builds and loads one library (``native/hostio.cc``
with ``g++``, ``io/native.py``). :class:`CudaLibrary` builds one
hand-written kernel of ``csrc/`` with plain ``nvcc`` (no PyTorch headers:
a few seconds) and is the one launch path of the port's kernels
(:meth:`CudaLibrary.launch`): the current stream, the device guard, the
CUDA error, the library's launch count and the tracer's ``kernel.<name>``
counter. A kernel's wrapper keeps only its argument checks, its output
allocation and its views.
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

from send_slam_tpu_torch.utils.profiling import count

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


def cuda_device(owner: str, x) -> torch.device:
    """The device of ``x``, once it is a CUDA tensor; else a ValueError
    naming ``owner`` (the wrapper)."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{owner} needs CUDA tensors")
    return x.device


def tensor_ptr(owner: str, x, name: str, shape, dtype, dev) -> int:
    """``x``'s data pointer, once it is a contiguous ``dtype`` tensor on
    ``dev`` of ``shape`` (any shape for None); else a TypeError or
    ValueError naming ``owner`` (the wrapper) and ``name`` (the
    argument)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{owner}: {name} must be a tensor")
    if x.device != dev:
        raise ValueError(f"{owner}: {name} lies on {x.device}, not {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{owner}: {name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{owner}: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{owner}: {name} must be contiguous")
    return x.data_ptr()


class NativeLibrary:
    """One source, its build and its loaded library.

    ``compiler`` names the compiler when a build runs (so the
    environment is read then); ``bind`` declares the argument and result
    types of the library's C entry points on the ``ctypes.CDLL`` once,
    when it is loaded. A failed build raises RuntimeError (a missing
    compiler may raise OSError, a build past ``timeout`` seconds
    ``subprocess.TimeoutExpired``)."""

    def __init__(self, source: Path, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None],
                 compiler: Callable[[], str],
                 timeout: Optional[float] = None):
        self.source = Path(source)
        self.flags = list(flags)
        self.build_dir = BUILD_DIR
        self.build_seconds: Optional[float] = None  # compiler wall time here
        self._bind = bind
        self._compiler = compiler
        self._timeout = timeout
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()
                                ).hexdigest()[:16]
        return self.build_dir / f"{self.source.stem}_{digest}.so"

    def report(self) -> str:
        """The compiler's output for the built library ('' before a
        build)."""
        log = self.path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def build(self) -> Path:
        """Compile the source if its library is missing; return its
        path. Writes to a temporary file renamed into place, so
        concurrent builders agree."""
        out = self.path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [self._compiler(), *self.flags, "-o", tmp, str(self.source)],
                capture_output=True, text=True, timeout=self._timeout)
            if proc.returncode != 0:
                raise RuntimeError("the build of %s failed:\n%s%s" % (
                    self.source, proc.stdout, proc.stderr))
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
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


class CudaLibrary(NativeLibrary):
    """One hand-written kernel of ``csrc/``, built with ``nvcc`` and
    BASE_FLAGS plus ``flags``. ``name``: the kernel's name in the
    tracer's ``kernel.<name>`` counter. ``launches`` counts the
    library's launches in this process."""

    def __init__(self, name: str, source: Path, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        super().__init__(source, [*BASE_FLAGS, *flags], bind, _nvcc)
        self.name = name
        self.launches = 0

    def launch(self, entry: str, dev: torch.device, *args) -> None:
        """Call the C entry point ``entry`` with ``args`` and the current
        stream of ``dev`` last, under ``dev``'s device guard; never
        syncs. A non-zero return raises RuntimeError and counts nothing;
        else the launch counts once here and once as ``kernel.<name>``."""
        lib = self.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = getattr(lib, entry)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
        self.launches += 1
        count(f"kernel.{self.name}")
