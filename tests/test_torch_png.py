"""The port's PNG reader (send_slam_tpu_torch/io/png.py) against
``cv2.imread``, which the JAX package's dataset loaders (gray mode,
``IMREAD_GRAYSCALE``) and producer (colour mode, ``IMREAD_COLOR``; the
port returns RGB where OpenCV returns BGR) call.

Bar: equal bit for bit, shape and dtype included, or None where cv2
returns None; ValueError for the variants the reader names as not
reproduced (and only those). Files come from a writer in this file (every
colour type and bit depth, each of the five row filters and mixes of
them, Adam7, IDAT split or empty, extra chunks), from cv2.imwrite and
from Pillow.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from send_slam_tpu_torch.io.png import decode_png, read_png

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
FILTERS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 2, 1, 3)]


def chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(a, depth):
    """(h, w, c) samples -> (h, row bytes) uint8."""
    h = a.shape[0]
    r = a.reshape(h, -1)
    if depth == 16:
        return r.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return r.astype(np.uint8)
    per = 8 // depth
    r = np.concatenate([r, np.zeros((h, (-r.shape[1]) % per), r.dtype)], 1)
    r = r.reshape(h, -1, per).astype(np.uint8)
    out = np.zeros(r.shape[:2], np.uint8)
    for i in range(per):
        out |= r[..., i] << (8 - depth * (i + 1))
    return out


def _filter(rows, bpp, ftypes):
    """Filtered scanlines, row y with ftypes[y % len(ftypes)]."""
    h, n = rows.shape
    x = rows.astype(np.int32)
    out, prev = [], np.zeros(n, np.int32)
    for y in range(h):
        f = ftypes[y % len(ftypes)]
        a = np.concatenate([np.zeros(bpp, np.int32), x[y, :-bpp]])[:n]
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:n]
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = (0, a, b, (a + b) >> 1, paeth)[f]
        out.append(bytes([f]) + ((x[y] - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
        prev = x[y]
    return b"".join(out)


def encode(a, depth, color, filters=(0,), interlace=0, plte=None,
           trns=None, pre=b"", post=b"", split=1):
    """A PNG of samples ``a`` ((h, w) or (h, w, c)): ``pre`` chunks after
    IHDR, then PLTE and tRNS, the IDAT stream in ``split`` chunks,
    ``post`` chunks, IEND."""
    a = np.asarray(a)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    bits = depth * c
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = a[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), max(1, bits // 8), filters)
    z = zlib.compress(raw)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace)) + pre
    if plte is not None:
        out += chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    cuts = [len(z) * i // split for i in range(split + 1)]
    for i in range(split):
        out += chunk(b"IDAT", z[cuts[i]:cuts[i + 1]])
    return out + post + chunk(b"IEND", b"")


def samples(rng, h, w, color, depth):
    a = rng.integers(0, 2 ** depth, (h, w, CHANNELS[color]))
    plte = (rng.integers(0, 256, (min(2 ** depth, 256), 3))
            if color == 3 else None)
    return a, plte


def cv_read(data: bytes, gray: bool, tmp_path):
    p = tmp_path / "cv.png"
    p.write_bytes(data)
    img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE if gray
                     else cv2.IMREAD_COLOR)
    return img if img is None or gray else img[..., ::-1]


def assert_as_cv2(data: bytes, tmp_path, modes=(True, False)):
    """decode_png equals cv2.imread in each mode (None where cv2's is)."""
    for gray in modes:
        ref = cv_read(data, gray, tmp_path)
        got = decode_png(data, gray)
        if ref is None:
            assert got is None, ("gray" if gray else "color")
        else:
            assert got is not None and got.dtype == ref.dtype \
                and got.shape == ref.shape, ("gray" if gray else "color")
            assert np.array_equal(got, ref), ("gray" if gray else "color")


@pytest.mark.parametrize("color,depth", KINDS)
def test_every_kind_filter_and_interlace(color, depth, tmp_path):
    """Every colour type at every bit depth, each row filter and mixes,
    plain and Adam7, at sizes that leave Adam7 passes empty and rows that
    end mid-byte."""
    rng = np.random.default_rng(100 * color + depth)
    for h, w in ((1, 1), (3, 5), (9, 13), (17, 33)):
        a, plte = samples(rng, h, w, color, depth)
        for filters in FILTERS:
            for interlace in (0, 1):
                assert_as_cv2(encode(a, depth, color, filters, interlace,
                                     plte=plte, split=3), tmp_path)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.sampled_from(KINDS),
       st.lists(st.integers(0, 4), min_size=1, max_size=6),
       st.booleans(), st.integers(1, 4), st.integers(0, 2 ** 31))
def test_hypothesis_sizes(h, w, kind, filters, interlace, split, seed):
    import tempfile
    from pathlib import Path
    color, depth = kind
    a, plte = samples(np.random.default_rng(seed), h, w, color, depth)
    data = encode(a, depth, color, tuple(filters), int(interlace),
                  plte=plte, split=split)
    with tempfile.TemporaryDirectory() as d:
        assert_as_cv2(data, Path(d))


def _gray_rgb_frame(h, w, seed):
    """A frame with texture, edges and gray pixels among colour ones."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0), 128 + 90 * np.cos(yy / 9.0),
                    (xx + yy) * 255.0 / (h + w)], -1)
    img += rng.normal(0, 6, img.shape)
    img[::5, ::3] = img[::5, ::3, :1]
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16",
                                  "rgb16"])
def test_files_written_by_cv2(kind, tmp_path):
    """cv2.imwrite at every compression level and at its strategies (its
    adaptive filters: Paeth and Average rows), 640x480."""
    rgb = _gray_rgb_frame(480, 640, 3)
    img = {"gray8": rgb[..., 0], "rgb8": rgb[..., ::-1],
           "rgba8": np.concatenate([rgb[..., ::-1], rgb[..., :1]], -1),
           "gray16": rgb[..., 0].astype(np.uint16) * 257 + 3,
           "rgb16": rgb[..., ::-1].astype(np.uint16) * 251}[kind]
    params = [[cv2.IMWRITE_PNG_COMPRESSION, lv] for lv in (0, 1, 6, 9)]
    params += [[cv2.IMWRITE_PNG_STRATEGY, s] for s in (
        cv2.IMWRITE_PNG_STRATEGY_FILTERED, cv2.IMWRITE_PNG_STRATEGY_RLE)]
    for flags in params:
        ok, buf = cv2.imencode(".png", img, flags)
        assert ok
        assert_as_cv2(buf.tobytes(), tmp_path)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "P", "1",
                                  "I;16"])
def test_files_written_by_pillow(mode, tmp_path):
    from PIL import Image
    rgb = _gray_rgb_frame(61, 83, 5)
    base = Image.fromarray(rgb)
    img = {"L": base.convert("L"), "RGB": base, "RGBA": base.convert("RGBA"),
           "LA": base.convert("LA"), "P": base.convert("P"),
           "1": base.convert("1"),
           "I;16": Image.fromarray(rgb[..., 1].astype(np.uint16) * 257)
           }[mode]
    for kw in ({}, {"optimize": True}, {"compress_level": 0}):
        buf = io.BytesIO()
        img.save(buf, "PNG", **kw)
        assert_as_cv2(buf.getvalue(), tmp_path)


def test_read_png_files(tmp_path):
    """read_png reads a file; a missing one is None, as in cv2."""
    rgb = _gray_rgb_frame(20, 30, 1)
    assert cv2.imwrite(str(tmp_path / "a.png"), rgb[..., ::-1])
    assert np.array_equal(read_png(str(tmp_path / "a.png"), gray=False), rgb)
    assert np.array_equal(read_png(str(tmp_path / "a.png")),
                          cv2.imread(str(tmp_path / "a.png"),
                                     cv2.IMREAD_GRAYSCALE))
    assert read_png(str(tmp_path / "none.png")) is None
    assert cv2.imread(str(tmp_path / "none.png")) is None


def test_palette_index_past_the_palette_reads_black(tmp_path):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 8, (9, 11))
    plte = rng.integers(0, 256, (5, 3))
    data = encode(idx, 8, 3, plte=plte, trns=bytes([0, 9]))
    assert_as_cv2(data, tmp_path)
    assert not decode_png(data, gray=False)[idx >= 5].any()


def _gamma(g):
    return chunk(b"gAMA", struct.pack(">I", g))


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "pal8", "gray8",
                                  "gray16", "graya8"])
def test_gamma_chunks(kind, tmp_path):
    """gAMA and sRGB chunks: in gray mode a colour file's 8-bit samples
    go through libpng's gamma tables when the gamma is significant; a
    gray file, colour mode, a chunk past PLTE or IDAT, a second gAMA or
    an invalid value are as cv2 reads them; cICP and cHRM change
    nothing."""
    rng = np.random.default_rng(8)
    color, depth = {"rgb8": (2, 8), "rgba8": (6, 8), "pal8": (3, 8),
                    "gray8": (0, 8), "gray16": (0, 16),
                    "graya8": (4, 8)}[kind]
    a, plte = samples(rng, 19, 27, color, depth)
    a[0, :5] = a[0, :5, :1]                     # gray pixels among colour
    pres = [_gamma(g) for g in (16, 20000, 45455, 50000, 94999, 95000,
                                100000, 105000, 105001, 220000, 625000000)]
    pres += [_gamma(0), _gamma(2 ** 31), chunk(b"gAMA", b"\0\0\1"),
             chunk(b"sRGB", b"\0"), chunk(b"sRGB", b"\3"),
             chunk(b"sRGB", b"\4"), chunk(b"sRGB", b"\0\0"),
             chunk(b"sRGB", b"\0") + _gamma(100000),
             _gamma(100000) + chunk(b"sRGB", b"\0"),
             _gamma(220000) + _gamma(100000), _gamma(100000) + _gamma(220000),
             chunk(b"cICP", bytes([1, 13, 0, 1])) + _gamma(220000),
             chunk(b"cICP", bytes([1, 8, 0, 1])),
             chunk(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000,
                                        30000, 60000, 15000, 6000))]
    for pre in pres:
        assert_as_cv2(encode(a, depth, color, plte=plte, pre=pre), tmp_path)
    assert_as_cv2(encode(a, depth, color, plte=plte, post=_gamma(220000)),
                  tmp_path)
    if plte is not None:
        data = encode(a, depth, color, plte=plte)
        i = data.index(b"IDAT") - 4               # gAMA after PLTE
        assert_as_cv2(data[:i] + _gamma(220000) + data[i:], tmp_path)


def _exif(order, orientation):
    if order == "<":
        head = b"II*\0"
    else:
        head = b"MM\0*"
    entries = [struct.pack(order + "HHI4s", 0x010F, 2, 4, b"ABC\0"),
               struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)]
    return (head + struct.pack(order + "IH", 8, len(entries))
            + b"".join(entries) + b"\0\0\0\0")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, tmp_path):
    """An eXIf chunk's orientation is applied as OpenCV applies it, in
    either byte order, before or after IDAT, and as Pillow writes it."""
    from PIL import Image
    rng = np.random.default_rng(orientation)
    g = rng.integers(0, 256, (7, 12))
    rgb = rng.integers(0, 256, (9, 13, 3))
    for order in "<>":
        ex = chunk(b"eXIf", _exif(order, orientation))
        assert_as_cv2(encode(g, 8, 0, pre=ex), tmp_path)
        assert_as_cv2(encode(rgb, 8, 2, post=ex), tmp_path)
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(rgb.astype(np.uint8)).save(buf, "PNG",
                                               exif=exif.tobytes())
    assert_as_cv2(buf.getvalue(), tmp_path)


def _chunk_offsets(data):
    pos, out = 8, []
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], pos, n))
        pos += 12 + n
    return out


def _flip_crc(data, i):
    _, pos, n = _chunk_offsets(data)[i]
    b = bytearray(data)
    b[pos + 8 + n] ^= 1
    return bytes(b)


def test_none_cases(tmp_path):
    """Where cv2.imread returns None the reader does too, and where cv2
    reads past a fault (a bad CRC on IEND or on an ancillary chunk, extra
    image data, bytes after IEND) it reads the same image."""
    rng = np.random.default_rng(2)
    H, W = 9, 14
    a = rng.integers(0, 256, (H, W, 3))
    good = encode(a, 8, 2, split=3)
    raw = b"".join(b"\0" + a[y].astype(np.uint8).tobytes() for y in range(H))
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)

    def build(z, head=ihdr):
        return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
                + chunk(b"IDAT", z) + chunk(b"IEND", b""))

    z = zlib.compress(raw)
    cases = [b"", b"hello world", b"\x89PNG\r\n\x1a\n",
             b"\x89PNG\r\n\x1a\x0b" + good[8:], good[:-12], good + b"junk",
             good + chunk(b"IDAT", b"xx"),
             good[:8] + chunk(b"IEND", b"") + good[8:]]
    cases += [good[:cut] for cut in (8, 20, 33, 40, len(good) - 30,
                                     len(good) - 13, len(good) - 4)]
    cases += [_flip_crc(good, i) for i in range(len(_chunk_offsets(good)))]
    text = chunk(b"tEXt", b"Comment\0hi")
    gam = _gamma(45455)
    cases += [encode(a, 8, 2, pre=t[:-1] + bytes([t[-1] ^ 1]))
              for t in (text, gam)]
    cases += [build(zlib.compress(raw[:-(3 * W + 1)])),
              build(zlib.compress(raw[:-5])),
              build(zlib.compress(raw + b"\0" * 30)), build(z[:-4]),
              build(z[:-1] + bytes([z[-1] ^ 1])),
              build(z[:len(z) // 2] + bytes([z[len(z) // 2] ^ 0x55])
                    + z[len(z) // 2 + 1:]),
              build(zlib.compress(b"\5" + raw[1:]))]
    for head in (struct.pack(">IIBBBBB", W, H, 3, 0, 0, 0, 0),
                 struct.pack(">IIBBBBB", W, H, 4, 2, 0, 0, 0),
                 struct.pack(">IIBBBBB", 0, H, 8, 2, 0, 0, 0),
                 struct.pack(">IIBBBBB", W, 0, 8, 2, 0, 0, 0),
                 struct.pack(">IIBBBBB", W, H, 8, 2, 1, 0, 0),
                 struct.pack(">IIBBBBB", W, H, 8, 2, 0, 1, 0),
                 struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 2),
                 struct.pack(">IIBBBBB", W, H, 8, 7, 0, 0, 0),
                 ihdr + b"\0"):
        cases.append(build(z, head))
    cases.append(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, 8, 3, 0, 0, 0)) + chunk(
        b"IDAT", zlib.compress(bytes(H * (W + 1)))) + chunk(b"IEND", b""))
    offs = _chunk_offsets(good)
    i1, i2 = offs[1][1], offs[2][1]
    cases += [good[:i2] + text + good[i2:],            # IDATs apart
              good[:i2] + chunk(b"IDAT", b"") + good[i2:],
              good[:i1] + chunk(b"IDAT", b"") + good[i1:],
              good[:i1] + chunk(b"IEND", b""),          # no IDAT
              good[:i1] + good[8:33] + good[i1:],       # a second IHDR
              encode(a, 8, 2, pre=chunk(b"ABCD", b"xx")),
              encode(a, 8, 2, pre=chunk(b"abCd", b"xx")),
              encode(a, 8, 2, post=chunk(b"XYZW", b"")),
              encode(a, 8, 2, post=chunk(b"PLTE", bytes(6))),
              encode(a, 8, 2, plte=np.zeros((4, 3)))]
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (H, W))
    p = encode(idx, 8, 3, plte=pal)
    k = p.index(b"IDAT") - 4
    q = encode(a, 8, 2, plte=pal)
    j = q.index(b"IDAT") - 4
    cases += [p[:-12] + chunk(b"PLTE", bytes(6)) + p[-12:],
              p[:k] + chunk(b"PLTE", bytes(6)) + p[k:],   # a second PLTE
              q[:j] + chunk(b"PLTE", bytes(6)) + q[j:],
              encode(idx, 8, 3, plte=pal.reshape(-1)[:47].reshape(-1, 1)),
              encode(idx, 8, 3, plte=np.zeros((0, 3))),
              encode(idx, 8, 3, plte=np.concatenate([pal] * 17)[:257]),
              encode(a, 8, 2, plte=pal.reshape(-1)[:47].reshape(-1, 1)),
              encode(a, 8, 2, trns=b"\0"),
              encode(idx % 4, 8, 3, plte=pal[:4], trns=bytes(20))]
    cases += [encode(rng.integers(0, 256, (1, 1_000_001)), 8, 0)]
    for data in cases:
        assert_as_cv2(data, tmp_path)
    assert decode_png(good[:-12]) is None and decode_png(b"") is None


def test_named_variants_raise(tmp_path):
    """The variants the reader does not reproduce raise ValueError naming
    them, where cv2 returns an image; in colour mode the gamma and iCCP
    cases are read (gamma only acts on the gray reduction)."""
    rng = np.random.default_rng(12)
    rgb16 = rng.integers(0, 65536, (9, 11, 3))
    rgb8 = rng.integers(0, 256, (9, 11, 3))
    icc = chunk(b"iCCP", b"x\0\0" + zlib.compress(b"junk" * 40))
    actl = chunk(b"acTL", struct.pack(">II", 1, 0))
    fctl = chunk(b"fcTL", struct.pack(">IIIIIHHBB", 0, 11, 9, 0, 0, 1, 30,
                                      0, 0))
    gray_only = [(encode(rgb16, 16, 2, pre=_gamma(45455)), "16-bit"),
                 (encode(rgb8, 8, 2, pre=chunk(b"sRGB", b"\0")), None),
                 (encode(rgb8, 8, 2, pre=icc), "iCCP"),
                 (encode(rgb8, 8, 2, pre=_gamma(15)), "gAMA 15"),
                 (encode(rgb8, 8, 2, pre=_gamma(2 ** 31 - 1)), "gAMA")]
    for data, name in gray_only:
        assert cv_read(data, True, tmp_path) is not None
        if name is None:                        # sRGB: reproduced
            assert_as_cv2(data, tmp_path)
            continue
        with pytest.raises(ValueError, match=name):
            decode_png(data, gray=True)
        assert_as_cv2(data, tmp_path, modes=(False,))
    both = [(encode(rgb8, 8, 2, pre=actl + fctl), "acTL"),
            (encode(rgb8, 8, 2, pre=chunk(b"eXIf", _exif("<", 9))), "eXIf"),
            (encode(rgb8, 8, 2, pre=chunk(b"eXIf", b"II*\0garbage")),
             "eXIf")]
    for data, name in both:
        for gray in (True, False):
            assert cv_read(data, gray, tmp_path) is not None
            with pytest.raises(ValueError, match=name):
                decode_png(data, gray=gray)
