"""msgpack's wire format for the file transport's records.

The JAX package writes each stream record as ``msgpack.packb(record,
use_bin_type=True)`` and reads it back with ``msgpack.unpackb(data,
raw=False)`` (``serving/queue_backend.py``). The port carries its own
codec of the same format, so it needs no ``msgpack`` package and the file
queues of both packages read each other's records. It is not a new
format: :func:`packb` gives msgpack's bytes and :func:`unpackb` its
objects, for the types a record carries:

- nil, bool, int (every width, signed and unsigned), float (packed as
  float64; float32 is read too), str (UTF-8), bin (``bytes``,
  ``bytearray``, ``memoryview``), array (``list``, ``tuple``; read back
  as ``list``) and map (``dict``, in insertion order);
- as in msgpack, the smallest encoding of each length and integer, a bool
  before an int, and on reading only ``str`` or ``bytes`` map keys
  (``strict_map_key``).

Extension types (msgpack's ``ExtType`` and timestamps) are no record's
type and raise, as any other unsupported object does.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb", "WireError"]


class WireError(ValueError):
    """Bytes that are not one complete msgpack object of a record type."""


_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _pack_int(n: int, out: List[bytes]):
    if 0 <= n < 0x80:
        out.append(_B.pack(n))
    elif -0x20 <= n < 0:
        out.append(_b.pack(n))
    elif 0 <= n <= 0xFF:
        out.append(b"\xcc" + _B.pack(n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + _b.pack(n))
    elif 0 <= n <= 0xFFFF:
        out.append(b"\xcd" + _H.pack(n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + _h.pack(n))
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(b"\xce" + _I.pack(n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + _i.pack(n))
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + _Q.pack(n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + _q.pack(n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, small: Tuple[int, int], codes: bytes,
              out: List[bytes]):
    """Header of a str/bin/array/map of ``n`` items: the fixed form
    (``small`` = (base byte, largest n), or None) else the 8/16/32-bit
    length codes in ``codes`` (a zero byte where a width does not
    exist)."""
    if small is not None and n <= small[1]:
        out.append(_B.pack(small[0] | n))
    elif n <= 0xFF and codes[0]:
        out.append(_B.pack(codes[0]) + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(_B.pack(codes[1]) + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(_B.pack(codes[2]) + _I.pack(n))
    else:
        raise ValueError(f"length {n} is too large for msgpack")


def _pack(obj: Any, out: List[bytes]):
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, b"\xc4\xc5\xc6", out)
        out.append(bytes(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), (0xA0, 31), b"\xd9\xda\xdb", out)
        out.append(data)
    elif isinstance(obj, memoryview):
        data = obj.tobytes()
        _pack_len(len(data), None, b"\xc4\xc5\xc6", out)
        out.append(data)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), (0x90, 15), b"\x00\xdc\xdd", out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), (0x80, 15), b"\x00\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise WireError("Unpack failed: incomplete input")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


# fixed-width scalars by type byte: (struct, is_float)
_SCALARS = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h,
            0xD2: _i, 0xD3: _q, 0xCA: _f, 0xCB: _d}
# sized types by type byte: (kind, struct of the length)
_SIZED = {0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
          0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
          0xDC: ("array", _H), 0xDD: ("array", _I),
          0xDE: ("map", _H), 0xDF: ("map", _I)}


def _unpack(r: _Reader) -> Any:
    c = r.unpack(_B)
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0xA0 <= c <= 0xBF:
        return _sized(r, "str", c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _sized(r, "array", c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _sized(r, "map", c & 0x0F)
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    st = _SCALARS.get(c)
    if st is not None:
        return r.unpack(st)
    sized = _SIZED.get(c)
    if sized is not None:
        kind, st = sized
        return _sized(r, kind, r.unpack(st))
    if c == 0xC1:
        raise WireError("unpack(b) received reserved byte")
    raise WireError(f"msgpack extension type 0x{c:02x} is not a record "
                    f"type")


def _sized(r: _Reader, kind: str, n: int) -> Any:
    if kind == "bin":
        return r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if type(k) not in (str, bytes):
            raise WireError(f"{type(k).__name__} is not allowed for map "
                            f"key when strict_map_key=True")
        out[k] = _unpack(r)
    return out


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False)``: one object, which must span
    ``data`` exactly."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise WireError("Unpack failed: extra data after the object")
    return obj
