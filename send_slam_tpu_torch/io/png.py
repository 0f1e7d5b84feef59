"""PNG decode without OpenCV: what ``cv2.imread`` returns for a PNG file.

The JAX package reads dataset frames with ``cv2.imread(path,
IMREAD_GRAYSCALE)`` (``send_slam_tpu/io/dataset.py``) and the producer
reads images with ``cv2.imread(path)``. OpenCV hands a PNG to libpng
with a fixed set of transforms. This module parses the chunks, inflates
the IDAT stream with ``zlib``, undoes the five row filters and Adam7
interlacing in numpy, and applies the same transforms:

- 16-bit samples keep their high byte (``png_set_strip_16``);
- 1-, 2- and 4-bit gray is scaled to 8 bits (v * 255 / (2^d - 1));
- a palette is expanded to RGB; an index past its end reads black;
- alpha and tRNS are dropped (``png_set_strip_alpha``);
- gray mode (``IMREAD_GRAYSCALE``): colour is reduced by libpng's
  fixed-point BT.601, (9797 R + 19234 G + 3737 B) >> 15 on 8-bit
  samples, with + 16384 before the shift on 16-bit ones (then the high
  byte). Where a gAMA or sRGB chunk puts the file gamma away from 1,
  8-bit samples go through libpng's gamma tables first (linearise,
  weigh with the rounding term, re-encode);
- colour mode (``IMREAD_COLOR``): gray is repeated in three channels.
  The channels are returned in RGB order (OpenCV's are BGR);
- an eXIf chunk's orientation is applied as OpenCV applies it.

``decode_png`` returns None where ``cv2.imread`` returns None: not a PNG
signature, a truncated file, a missing IEND, a critical chunk with a bad
CRC or of an unknown type, invalid IHDR fields, a palette image without
PLTE, a zlib stream that is corrupt or ends early, too little image
data, a bad filter byte. An ancillary chunk with a bad CRC is skipped.

Variants it does not reproduce raise ValueError naming the variant, never
a different image: in gray mode, a colour file with a significant gamma
on 16-bit samples, with an iCCP chunk (libpng takes a known sRGB
profile's gamma) or with a gAMA value outside 16..625000000; in either
mode an animated PNG (acTL) and an eXIf chunk whose orientation is not a
SHORT 1..8.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libpng's default user limits (PNG_USER_WIDTH_MAX, PNG_USER_HEIGHT_MAX).
MAX_SIDE = 1_000_000
# Valid bit depths per colour type, and samples per pixel.
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) coefficients
# (15-bit fixed point; they sum to 32768).
_RC, _GC, _BC = 9797, 19234, 3737
# libpng's fixed point: 1.0 is 100000; a gamma within 5% of 1 is not
# significant (PNG_GAMMA_THRESHOLD_FIXED).
_FP_1, _GAMMA_THRESHOLD = 100000, 5000
_sRGB_GAMMA = 45455             # PNG_GAMMA_sRGB_INVERSE


class _Invalid(Exception):
    """The file is one that cv2.imread returns None for."""


def read_png(path: str, gray: bool = True) -> Optional[np.ndarray]:
    """A PNG file -> (H, W) uint8 (``gray``) or (H, W, 3) uint8 RGB, or
    None where ``cv2.imread`` returns None (a missing file included)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_png(data, gray)


def decode_png(data: bytes, gray: bool = True) -> Optional[np.ndarray]:
    """PNG bytes -> (H, W) uint8 (``gray``) or (H, W, 3) uint8 RGB, or
    None where ``cv2.imdecode`` returns None; ValueError for a variant
    this reader does not reproduce (see the module docstring)."""
    try:
        hdr, chunks = _parse(data)
        samples = _samples(hdr, chunks)
        return _orient(_convert(hdr, chunks, samples, gray), chunks)
    except _Invalid:
        return None


# ---------------------------------------------------------------------------
# Chunks


def _parse(data: bytes) -> Tuple[Dict[str, int], Dict[bytes, list]]:
    """Walk the chunks up to IEND. Returns the IHDR fields and the data
    of the chunks kept, by type, in file order."""
    if not data.startswith(SIGNATURE):
        raise _Invalid
    pos, n = len(SIGNATURE), len(data)
    chunks: Dict[bytes, list] = {}
    hdr = None
    idat = 0                # 0: before the IDAT run, 1: in it, 2: past it
    while True:
        if pos + 8 > n:
            raise _Invalid                  # truncated, or no IEND
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if length > 0x7FFFFFFF or pos + 12 + length > n:
            raise _Invalid
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        pos += 12 + length
        critical = not ctype[0] & 0x20
        crc_ok = zlib.crc32(ctype + body) & 0xFFFFFFFF == crc
        if hdr is None:
            if ctype != b"IHDR" or not crc_ok:
                raise _Invalid
            hdr = _ihdr(body)
            continue
        if ctype == b"IEND":
            break                           # its CRC is not checked
        if not crc_ok:
            if critical:
                raise _Invalid
            continue                        # libpng skips it
        if ctype == b"IDAT":
            if idat == 2 or (hdr["color"] == 3 and b"PLTE" not in chunks):
                raise _Invalid              # IDATs apart, or no PLTE
            idat = 1
        elif idat == 1:
            idat = 2
        if ctype == b"PLTE":
            if hdr["color"] == 3 and (idat or b"PLTE" in chunks):
                raise _Invalid              # past IDAT, or a second one
            if idat or b"PLTE" in chunks:
                continue
        elif critical and ctype != b"IDAT":
            raise _Invalid                  # unknown critical chunk
        elif ctype in (b"gAMA", b"sRGB") and (idat or b"PLTE" in chunks):
            continue                        # out of place: ignored
        chunks.setdefault(ctype, []).append(body)
    if not idat:
        raise _Invalid
    return hdr, chunks


def _ihdr(body: bytes) -> Dict[str, int]:
    """IHDR's fields; a value libpng refuses makes the file invalid."""
    if len(body) != 13:
        raise _Invalid
    w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", body)
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE) \
            or color not in _DEPTHS or depth not in _DEPTHS[color] \
            or comp or filt or inter > 1:
        raise _Invalid
    return dict(w=w, h=h, depth=depth, color=color, interlace=inter)


# ---------------------------------------------------------------------------
# Image data


def _inflate(chunks) -> bytes:
    """The IDAT stream inflated; it must end (adler32 included)."""
    d = zlib.decompressobj()
    try:
        raw = d.decompress(b"".join(chunks[b"IDAT"])) + d.flush()
    except zlib.error:
        raise _Invalid from None
    if not d.eof:
        raise _Invalid                      # "Not enough image data"
    return raw


def _unfilter(raw: np.ndarray, rows: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the row filters of ``rows`` filtered rows (each a filter
    byte and ``row_bytes`` bytes; ``bpp`` bytes per complete pixel, at
    least 1) -> (rows, row_bytes) uint8.

    None, Sub and Up rows are whole-row numpy operations. A row with
    Average or Paeth depends on the pixel to its left, so an image that
    has one is decoded along anti-diagonals of pixels (y + x constant),
    whose pixels depend only on earlier diagonals: one strided slice of
    a padded array per diagonal."""
    buf = raw[:rows * (row_bytes + 1)].reshape(rows, row_bytes + 1)
    ftype = buf[:, 0]
    if (ftype > 4).any():
        raise _Invalid                      # "bad adaptive filter value"
    data = buf[:, 1:]
    if (ftype <= 2).all():
        out = np.empty((rows, row_bytes), np.uint8)
        prev = np.zeros(row_bytes, np.uint8)
        for y in range(rows):
            row = data[y]
            if ftype[y] == 1:
                # Sub: a running sum along each byte lane, wrapping at 256.
                lanes = np.zeros(-(-row_bytes // bpp) * bpp, np.uint8)
                lanes[:row_bytes] = row
                row = np.cumsum(lanes.reshape(-1, bpp), 0, dtype=np.uint8
                                ).reshape(-1)[:row_bytes]
            elif ftype[y] == 2:
                row = row + prev            # uint8 wraps
            out[y] = row
            prev = out[y]
        return out
    return _unfilter_diagonal(data, ftype, row_bytes, bpp)


def _unfilter_diagonal(data, ftype, row_bytes, bpp):
    """_unfilter for any filters: anti-diagonals of a zero-padded
    (rows + 1, pixels + 1, bpp) array of int32. The predictor is a sum of
    the four filters' predictions, each weighed by 0 or 1 by its row's
    filter type (cheaper in numpy than a select)."""
    rows = data.shape[0]
    px = -(-row_bytes // bpp)
    body = np.zeros((rows, px * bpp), np.int32)
    body[:, :row_bytes] = data
    raw = np.zeros((rows + 1, px + 1, bpp), np.int32)
    raw[1:, 1:] = body.reshape(rows, px, bpp)
    weights = np.zeros((5, rows + 1, px + 1), np.int32)
    weights[ftype, np.arange(1, rows + 1)] = 1
    w_sub, w_up, w_avg, w_paeth = (w.reshape(-1, 1) for w in weights[1:])
    out = np.zeros_like(raw)
    stride = px + 1                          # one row of padded pixels
    rf, of = raw.reshape(-1, bpp), out.reshape(-1, bpp)
    for k in range(rows + px - 1):
        # Pixels (y, x), y + x = k, at padded (y + 1, x + 1): flat index
        # (y + 1) * stride + k - y + 1, a step of px from one y to the next.
        y0, y1 = max(0, k - px + 1), min(rows - 1, k)
        s = (y0 + 1) * stride + k - y0 + 1
        e = (y1 + 1) * stride + k - y1 + 2
        sl = slice(s, e, px)
        a = of[s - 1:e - 1:px]               # left
        b = of[s - stride:e - stride:px]     # up
        c = of[s - stride - 1:e - stride - 1:px]
        bc, ac = b - c, a - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (w_sub[sl] * a + w_up[sl] * b + w_avg[sl] * ((a + b) >> 1)
                + w_paeth[sl] * paeth)
        of[sl] = (rf[sl] + pred) & 0xFF
    return out[1:, 1:].reshape(rows, -1)[:, :row_bytes].astype(np.uint8)


def _unpack(rows: np.ndarray, w: int, depth: int, channels: int):
    """Unfiltered rows -> (h, w, channels) samples (uint16 at depth 16,
    else uint8 at their own depth)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = rows
    else:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        s = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
        s = s[:, :w * channels]
    return s.reshape(h, w, channels)


def _samples(hdr, chunks) -> np.ndarray:
    """(H, W, channels) samples of the image, Adam7 undone."""
    w, h, depth, color = hdr["w"], hdr["h"], hdr["depth"], hdr["color"]
    ch = _CHANNELS[color]
    bits = depth * ch
    bpp = max(1, bits // 8)
    raw = np.frombuffer(_inflate(chunks), np.uint8)
    passes = (_ADAM7 if hdr["interlace"] else ((0, 0, 1, 1),))
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        row_bytes = -(-pw * bits // 8)
        need = ph * (row_bytes + 1)
        if pos + need > raw.size:
            raise _Invalid                  # "Not enough image data"
        rows = _unfilter(raw[pos:pos + need], ph, row_bytes, bpp)
        out[y0::dy, x0::dx] = _unpack(rows, pw, depth, ch)
        pos += need
    return out


# ---------------------------------------------------------------------------
# libpng's transforms


def _fixed(x: float) -> int:
    """A double rounded to libpng fixed point, as png_reciprocal does."""
    r = math.floor(x + 0.5)
    return int(r) if -2147483648 <= r <= 2147483647 else 0


def _significant(g: int) -> bool:
    return g < _FP_1 - _GAMMA_THRESHOLD or g > _FP_1 + _GAMMA_THRESHOLD


def _table8(g: int) -> np.ndarray:
    """png_build_8bit_table: 256 entries of png_gamma_8bit_correct."""
    if not _significant(g):
        return np.arange(256, dtype=np.int64)
    t = [0] + [int(math.floor(255 * math.pow(i / 255.0, g * 0.00001) + 0.5))
               for i in range(1, 255)] + [255]
    return np.asarray(t, np.int64)


def _file_gamma(chunks) -> int:
    """The file gamma libpng takes from an sRGB chunk (which wins) or the
    first gAMA chunk; 0 if neither. ValueError for a gAMA value that
    libpng takes but that this reader does not reproduce."""
    if b"sRGB" in chunks and len(chunks[b"sRGB"][0]) == 1 \
            and chunks[b"sRGB"][0][0] <= 3:
        return _sRGB_GAMMA
    if b"gAMA" in chunks and len(chunks[b"gAMA"][0]) == 4:
        g, = struct.unpack(">I", chunks[b"gAMA"][0])
        if 16 <= g <= 625000000:
            return g
        if 0 < g <= 0x7FFFFFFF:
            raise ValueError(f"gray mode of a colour PNG with gAMA {g} "
                             "(outside 16..625000000) is not read")
    return 0


def _gamma(chunks) -> Optional[Tuple[int, int]]:
    """(file gamma, screen gamma) where libpng's gray reduction goes
    through its gamma tables (either one significant), else None. With no
    screen gamma set, libpng takes the file gamma's reciprocal."""
    g = _file_gamma(chunks)
    if not g:
        return None
    screen = _fixed(1e10 / g)
    return (g, screen) if _significant(g) or _significant(screen) else None


def _luma(rgb: np.ndarray, depth: int, gamma) -> np.ndarray:
    """libpng's rgb_to_gray of (H, W, 3) samples -> (H, W) at ``depth``;
    ``gamma`` from _gamma (8-bit samples only)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if depth == 16:
        return (_RC * r + _GC * g + _BC * b + 16384) >> 15
    if gamma is None:
        return (_RC * r + _GC * g + _BC * b) >> 15
    file_g, screen_g = gamma
    to_1 = _table8(_fixed(1e10 / file_g))
    from_1 = _table8(_fixed(1e10 / screen_g))
    same = _table8(_fixed(1e15 / file_g / screen_g))
    mixed = from_1[(_RC * to_1[r] + _GC * to_1[g] + _BC * to_1[b] + 16384)
                   >> 15]
    return np.where((r == g) & (r == b), same[r], mixed)


def _convert(hdr, chunks, s: np.ndarray, gray: bool) -> np.ndarray:
    depth, color = hdr["depth"], hdr["color"]
    if b"acTL" in chunks:
        raise ValueError("animated PNG (acTL) is not read")
    if color == 3:
        plte = chunks[b"PLTE"][0]
        if len(plte) % 3 or not 0 < len(plte) <= 3 * 256:
            raise _Invalid                  # "Invalid palette length"
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        rgb, depth = pal[s[..., 0]], 8
    elif color in (2, 6):
        rgb = s[..., :3]
    else:
        v = s[..., 0]
        if depth == 16:
            v = v >> 8
        elif depth < 8:
            v = v * (255 // ((1 << depth) - 1))
        v = v.astype(np.uint8)
        return v if gray else np.repeat(v[..., None], 3, axis=2)
    if not gray:
        return (rgb >> 8 if depth == 16 else rgb).astype(np.uint8)
    if b"iCCP" in chunks:
        raise ValueError("gray mode of a colour PNG with an iCCP chunk is "
                         "not read (libpng takes a known sRGB profile's "
                         "gamma)")
    gamma = _gamma(chunks)
    if depth == 16 and gamma:
        raise ValueError("gray mode of a 16-bit colour PNG with a "
                         "significant gAMA or sRGB chunk is not read")
    v = _luma(rgb, depth, gamma)
    return (v >> 8 if depth == 16 else v).astype(np.uint8)


def _orient(img: np.ndarray, chunks) -> np.ndarray:
    """The EXIF orientation of an eXIf chunk applied as OpenCV's
    ApplyExifOrientation applies it (1: as stored ... 8)."""
    if b"eXIf" not in chunks:
        return img
    o = _exif_orientation(chunks[b"eXIf"][0])
    if o >= 5:                                  # the row/column swaps
        img = img.swapaxes(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(o, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def _exif_orientation(exif: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of an EXIF block, 1 without
    one; ValueError for a block or value this reader does not follow."""
    order = {b"II*\0": "<", b"MM\0*": ">"}.get(exif[:4])
    try:
        if order is None:
            raise struct.error
        off, = struct.unpack(order + "I", exif[4:8])
        n, = struct.unpack(order + "H", exif[off:off + 2])
        for i in range(n):
            e = off + 2 + 12 * i
            tag, typ, count = struct.unpack(order + "HHI", exif[e:e + 8])
            if tag == 0x0112:
                value, = struct.unpack(order + "H", exif[e + 8:e + 10])
                if typ != 3 or count != 1 or not 1 <= value <= 8:
                    raise struct.error
                return value
    except struct.error:
        raise ValueError("PNG with an eXIf chunk whose orientation is not "
                         "a SHORT 1..8 in IFD0 is not read") from None
    return 1
