"""The card's busy time over a whole window: the union of the intervals in
which a kernel, copy or fill ran on the device, from CUPTI's activity
records, gathered and merged in C (``devclock.c``). A window of a
host-bound program holds millions of records; none passes through
Python, and none is dropped unseen (CUPTI counts what it drops).

The library is built once per checkout into ``.bench_build/`` at its root
(a fixed directory, listed in ``.gitignore``), named by the source's
hash, and takes CUPTI's entry points from the CUPTI the process has
loaded (PyTorch's profiler links one), else from the CUDA toolkit's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

SRC = Path(__file__).with_name("devclock.c")
BUILD = Path(__file__).resolve().parents[2] / ".bench_build"
CUPTI = ("libcupti.so.12", "libcupti.so",
         "/usr/local/cuda/extras/CUPTI/lib64/libcupti.so")
ENTRIES = ("cuptiActivityRegisterCallbacks", "cuptiActivityEnable",
           "cuptiActivityDisable", "cuptiActivityFlushAll",
           "cuptiActivityGetNextRecord", "cuptiActivityGetNumDroppedRecords")
OUT = 7                   # dc_busy's numbers

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD / f"devclock-{digest}.so"


def build() -> Path:
    """The shared library, compiled if this checkout has none yet."""
    out = library_path()
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        part = out.with_name(out.name + f".part{os.getpid()}")
        subprocess.run([os.environ.get("CC", "cc"), "-O2", "-shared",
                        "-fPIC", "-o", str(part), str(SRC), "-lpthread"],
                       check=True)
        os.replace(part, out)
    return out


def _cupti() -> ctypes.CDLL:
    with open("/proc/self/maps") as f:
        for line in f:
            if "libcupti" in line:
                return ctypes.CDLL(line.split()[-1])
    errors = []
    for name in CUPTI:
        try:
            return ctypes.CDLL(name)
        except OSError as e:
            errors.append(str(e))
    raise OSError("no CUPTI library: " + "; ".join(errors))


def load() -> ctypes.CDLL:
    """The library, built, loaded and registered with CUPTI (once per
    process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        cupti = _cupti()
        ptrs = [ctypes.cast(getattr(cupti, n), ctypes.c_void_p)
                for n in ENTRIES]
        lib.dc_init.argtypes = [ctypes.c_void_p] * len(ENTRIES)
        rc = lib.dc_init(*ptrs)
        if rc:
            raise RuntimeError(f"CUPTI refused the callbacks ({rc})")
        _lib = lib
    return _lib


def busy(lib) -> Dict:
    """What the library holds: busy seconds, device intervals, dropped
    records, buffers read, and whether an allocation failed."""
    out = (ctypes.c_uint64 * OUT)()
    lib.dc_busy(out)
    return dict(busy_s=out[0] * 1e-9, events=int(out[1]),
                dropped=int(out[4]), buffers=int(out[5]),
                failed=bool(out[6]))


class DeviceClock:
    """Records the card's activity between ``start`` and ``stop``; built
    and registered when made, so that the build counts as set-up."""

    def __init__(self, sync):
        self.sync = sync
        self.lib = load()
        self._on = False

    def start(self) -> None:
        self.sync()
        self.lib.dc_reset()
        rc = self.lib.dc_start()
        if rc:
            raise RuntimeError(f"CUPTI refused the activity kinds ({rc})")
        self._on = True

    def stop(self) -> Optional[Dict]:
        """The window's record once its work has finished; None if the
        clock was not running."""
        if not self._on:
            return None
        self._on = False
        self.sync()
        rc = self.lib.dc_stop()
        got = busy(self.lib)
        got["flush_rc"] = int(rc)
        return got
