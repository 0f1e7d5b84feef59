"""MessagePack encode/decode for the wire protocol, in the standard library.

The card's machine has no ``msgpack`` package, so the port packs and
unpacks the protocol's packets itself (``io/protocol.py``).

``packb(obj)`` is byte-identical to ``msgpack.packb(obj,
use_bin_type=True)`` for the types the protocol carries: nil, bool,
integers in their shortest form (unsigned widths for non-negative
values, signed widths for negative ones), Python floats as float64
(``0xcb``; never float32), str (fixstr, str8/16/32), bytes-like objects
(bin8/16/32), lists and tuples (fixarray, array16/32) and dicts (fixmap,
map16/32, in insertion order). Like ``msgpack``, it packs subclasses of
these types as the base type and raises ``TypeError`` on any other type
and ``OverflowError`` on integers outside [-2**63, 2**64).

``unpackb(data)`` is ``msgpack.unpackb(data, raw=False)``: every format
of the specification except the extension types (which raise
``ValueError``), float32 included, since the reference's Elixir host and
C++ backend may send any width. Arrays decode to lists, bin to bytes,
str as UTF-8. Truncated input, trailing bytes, the reserved byte
``0xc1`` and unhashable map keys raise ``ValueError``.

Large binaries (a 921,615-byte PPM frame) are handled as whole slices:
one ``bytes.join`` on packing, one slice copy on unpacking.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


# ---------------------------------------------------------------------------
# Packing


def _pack_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_U8.pack(v))
        elif v <= 0xFF:
            out.append(b"\xcc" + _U8.pack(v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + _U16.pack(v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + _U32.pack(v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _U64.pack(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(_I8.pack(v))
    elif v >= -0x80:
        out.append(b"\xd0" + _I8.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _I16.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _I32.pack(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _I64.pack(v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[bytes, ...],
              out: List[bytes]) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-bit
    (when ``codes[0]`` is given), 16- or 32-bit form."""
    if n < fix_max:
        out.append(_U8.pack(fix | n))
    elif codes[0] and n <= 0xFF:
        out.append(codes[0] + _U8.pack(n))
    elif n <= 0xFFFF:
        out.append(codes[1] + _U16.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(codes[2] + _U32.pack(n))
    else:
        raise ValueError(f"object too large for MessagePack: {n}")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = obj if isinstance(obj, bytes) else bytes(obj)
        if len(b) <= 0xFF:
            out.append(b"\xc4" + _U8.pack(len(b)))
        elif len(b) <= 0xFFFF:
            out.append(b"\xc5" + _U16.pack(len(b)))
        elif len(b) <= 0xFFFFFFFF:
            out.append(b"\xc6" + _U32.pack(len(b)))
        else:
            raise ValueError(f"bin too large for MessagePack: {len(b)}")
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (b"", b"\xdc", b"\xdd"), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (b"", b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` -> MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)``)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Unpacking

# Fixed-width scalars: code -> (struct, size).
_SCALARS = {
    0xCA: _F32, 0xCB: _F64,
    0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
    0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64,
}
# Length-prefixed: code -> (kind, struct of the length).
_SIZED = {
    0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
    0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
    0xDC: ("array", _U16), 0xDD: ("array", _U32),
    0xDE: ("map", _U16), 0xDF: ("map", _U32),
}
_EXT = frozenset((0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8))


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        b = self.data[self.pos:end]
        self.pos = end
        return b

    def scalar(self, st: struct.Struct):
        end = self.pos + st.size
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        (v,) = st.unpack_from(self.data, self.pos)
        self.pos = end
        return v


def _unpack(r: _Reader) -> Any:
    code = r.scalar(_U8)
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0xA0 <= code <= 0xBF:
        return _str(r.take(code & 0x1F))
    if 0x90 <= code <= 0x9F:
        return [_unpack(r) for _ in range(code & 0x0F)]
    if 0x80 <= code <= 0x8F:
        return _map(r, code & 0x0F)
    if code == 0xC0:
        return None
    if code == 0xC2:
        return False
    if code == 0xC3:
        return True
    st = _SCALARS.get(code)
    if st is not None:
        return r.scalar(st)
    sized = _SIZED.get(code)
    if sized is not None:
        kind, lst = sized
        n = r.scalar(lst)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return _str(r.take(n))
        if kind == "array":
            return [_unpack(r) for _ in range(n)]
        return _map(r, n)
    if code in _EXT:
        raise ValueError(f"MessagePack ext type 0x{code:02x} is not "
                         "supported")
    raise ValueError(f"invalid MessagePack byte 0x{code:02x}")


def _str(b: bytes) -> str:
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"invalid UTF-8 in MessagePack str: {e}") from None


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        v = _unpack(r)
        try:
            out[k] = v
        except TypeError:
            raise ValueError(f"unhashable map key {type(k).__name__}") \
                from None
    return out


def unpackb(data) -> Any:
    """MessagePack bytes -> object (``msgpack.unpackb(data,
    raw=False)``)."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("Unpack failed: extra data after the object")
    return obj
