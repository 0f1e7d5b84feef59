"""ctypes bindings for the native host-I/O library (native/hostio.cc).

The port's own copy of ``send_slam_tpu/io/native.py``. The library is
built on first use from the repo's ``native/hostio.cc`` with ``$CXX``
(``g++`` by default) and the flags of ``native/Makefile``, into
``send_slam_tpu_torch/_build/`` (the JAX package builds into
``native/``), by the port's one builder (``ops/cuda_build.py``
``NativeLibrary``); when the build or the load fails, the pure-numpy
implementations of ``io/ppm.py`` are used. This is host code:
``decode_ppm_gray`` / ``extract_packets_native`` are the per-frame calls
of the wire path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from send_slam_tpu_torch.io.ppm import decode_ppm, rgb_to_gray_u8
from send_slam_tpu_torch.io.ppm import encode_ppm as np_encode_ppm
from send_slam_tpu_torch.ops.cuda_build import NativeLibrary

log = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "hostio.cc"
# native/Makefile: CXXFLAGS, then -shared -fPIC.
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-Wextra",
             "-shared", "-fPIC")


def _bind(lib: ctypes.CDLL) -> None:
    lib.ppm_probe.restype = ctypes.c_int
    lib.ppm_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ppm_decode_gray.restype = ctypes.c_int
    lib.ppm_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_int]
    lib.rgb_to_gray.restype = None
    lib.rgb_to_gray.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.ppm_encode.restype = ctypes.c_long
    lib.ppm_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long]
    lib.extract_packets.restype = ctypes.c_int
    lib.extract_packets.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]


LIBRARY = NativeLibrary(SOURCE, CXX_FLAGS, _bind,
                        compiler=lambda: os.environ.get("CXX", "g++"),
                        timeout=120)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _lib = LIBRARY.load()
        log.info("native hostio loaded: %s", LIBRARY.path())
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        log.warning("native hostio unavailable (%s); using numpy fallback", e)
    return _lib


def available() -> bool:
    return _load() is not None


def decode_ppm_gray(data: bytes) -> np.ndarray:
    """Binary PPM/PGM bytes -> (H, W) uint8 grayscale (fused luma)."""
    lib = _load()
    if lib is None:
        img = decode_ppm(data)
        return rgb_to_gray_u8(img) if img.ndim == 3 else img
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.ppm_probe(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("not a binary PPM/PGM")
    out = np.empty((h.value, w.value), np.uint8)
    rc = lib.ppm_decode_gray(data, len(data),
                             out.ctypes.data_as(ctypes.c_void_p), out.size)
    if rc != 0:
        raise ValueError(f"ppm decode failed: {rc}")
    return out


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None or not rgb.flags.c_contiguous:
        return rgb_to_gray_u8(rgb)
    n = rgb.shape[0] * rgb.shape[1]
    out = np.empty(rgb.shape[:2], np.uint8)
    lib.rgb_to_gray(rgb.ctypes.data_as(ctypes.c_void_p), n,
                    out.ctypes.data_as(ctypes.c_void_p))
    return out


def encode_ppm(img: np.ndarray) -> bytes:
    lib = _load()
    if lib is None or not img.flags.c_contiguous:
        return np_encode_ppm(img)
    channels = 3 if img.ndim == 3 else 1
    cap = img.size + 64
    out = np.empty(cap, np.uint8)
    n = lib.ppm_encode(img.ctypes.data_as(ctypes.c_void_p),
                       img.shape[1], img.shape[0], channels,
                       out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise ValueError("ppm encode failed")
    return out[:n].tobytes()


def extract_packets_native(
    buf: bytes, max_packets: int = 64,
    max_packet_len: int = 50 * 1024 * 1024,
) -> Tuple[List[bytes], int]:
    """Scan for complete length-prefixed packets. Returns (bodies,
    consumed_bytes); the caller retains buf[consumed:]."""
    lib = _load()
    if lib is None:
        # struct fallback with identical semantics.
        bodies, pos = [], 0
        while len(bodies) < max_packets and pos + 4 <= len(buf):
            (plen,) = struct.unpack(">I", buf[pos:pos + 4])
            if plen > max_packet_len:
                raise ValueError("packet exceeds guard")
            if pos + 4 + plen > len(buf):
                break
            bodies.append(buf[pos + 4: pos + 4 + plen])
            pos += 4 + plen
        return bodies, pos
    offsets = (ctypes.c_size_t * max_packets)()
    lengths = (ctypes.c_size_t * max_packets)()
    consumed = ctypes.c_size_t()
    n = lib.extract_packets(buf, len(buf), offsets, lengths, max_packets,
                            max_packet_len, ctypes.byref(consumed))
    if n < 0:
        raise ValueError("packet exceeds guard")
    bodies = [buf[offsets[i]: offsets[i] + lengths[i]] for i in range(n)]
    return bodies, consumed.value
