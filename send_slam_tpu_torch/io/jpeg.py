"""JPEG for the panel: what ``send_slam_tpu/server/web.py`` gets from
``cv2.imencode(".jpg", ...)`` and ``cv2.imdecode(..., IMREAD_GRAYSCALE)``.

Both run through Pillow's libjpeg, imported when a function is called
(the port loads without it):

- ``encode_jpeg``: baseline JFIF of an (H, W, 3) RGB uint8 frame at
  OpenCV's defaults, quality 95 and 4:2:0 chroma subsampling;
- ``decode_jpeg_gray``: the decoder's own luma (Y) plane, which is what
  libjpeg hands OpenCV for ``IMREAD_GRAYSCALE`` of a colour file (not a
  luma weighted from decoded RGB). Undecodable bytes raise ValueError.
"""

from __future__ import annotations

import io

import numpy as np

QUALITY = 95        # cv2.IMWRITE_JPEG_QUALITY's default


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> JPEG bytes (baseline, 4:2:0)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb, np.uint8), "RGB").save(
        buf, "JPEG", quality=QUALITY, subsampling="4:2:0")
    return buf.getvalue()


def decode_jpeg_gray(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W) uint8: the Y plane of a colour file, the
    samples of a grayscale one."""
    from PIL import Image
    try:
        img = Image.open(io.BytesIO(data))
        if img.format != "JPEG":
            raise ValueError(f"not a JPEG file ({img.format})")
        img.draft("L", img.size)     # libjpeg writes Y out directly
        return np.asarray(img.convert("L"))
    except OSError as e:             # PIL's UnidentifiedImageError too
        raise ValueError(f"undecodable JPEG: {e}") from e
