"""Binary PPM (P6) / PGM (P5) encode/decode.

The port's own copy of ``send_slam_tpu/io/ppm.py``.

The reference ships frames as uncompressed binary PPM
(image_logger.ex:215-223 encodes via Evision ".ppm"; the backend
decodes with cv::imdecode, …cc:546). PPM is trivial: header
``P6\\n<w> <h>\\n255\\n`` + raw RGB bytes — so we parse it in numpy with
no OpenCV dependency on the hot path.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

_HEADER_RE = re.compile(rb"^(P[56])\s+(?:#[^\n]*\s+)*(\d+)\s+(\d+)\s+(\d+)\s")


def encode_ppm(img: np.ndarray) -> bytes:
    """uint8 (H,W,3) RGB -> binary P6; (H,W) -> P5."""
    if img.dtype != np.uint8:
        raise ValueError("PPM encoder expects uint8")
    if img.ndim == 3 and img.shape[2] == 3:
        header = b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0])
    elif img.ndim == 2:
        header = b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0])
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    return header + img.tobytes()


def decode_ppm(data: bytes) -> np.ndarray:
    """Binary P6 -> (H,W,3) uint8; P5 -> (H,W) uint8."""
    m = _HEADER_RE.match(data)
    if not m:
        raise ValueError("not a binary PPM/PGM (P6/P5)")
    magic, w, h, maxval = m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))
    if maxval != 255:
        raise ValueError(f"unsupported maxval {maxval}")
    offset = m.end()
    channels = 3 if magic == b"P6" else 1
    n = w * h * channels
    arr = np.frombuffer(data, dtype=np.uint8, count=n, offset=offset)
    if channels == 3:
        return arr.reshape(h, w, 3)
    return arr.reshape(h, w)


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """BT.601 luma like cv2.cvtColor RGB2GRAY, uint8 rounding."""
    f = img.astype(np.float32)
    g = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    return np.clip(np.round(g), 0, 255).astype(np.uint8)
