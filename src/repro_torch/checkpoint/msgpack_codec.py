"""A small MessagePack codec for checkpoint metadata: ``packb`` and
``unpackb`` for dict, list/tuple, str, int, float, bool and None.

``repro`` writes ``meta.msgpack`` with ``msgpack.packb`` and reads it with
``msgpack.unpackb``; the machine with the card has no ``msgpack``, so the
port carries this codec.  ``packb`` gives ``msgpack.packb``'s bytes under its
defaults (``use_bin_type=True``: the smallest int encoding, float64 for
floats, str8 for strings of 32-255 bytes, arrays for tuples too) and
``unpackb`` its values (``raw=False``, arrays as lists);
``tests/test_torch_checkpoint.py`` holds both to ``msgpack``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _head(out: List[bytes], n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
    """A container or string header: the fix form below ``fix_max``, else
    the 8-, 16- or 32-bit length form (``codes``; 0 where there is none)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"length {n} too large for msgpack")


def _pack_int(out: List[bytes], v: int) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            out.append(struct.pack(">Bi", 0xD2, v) if v >= -(1 << 31)
                       else struct.pack(">Bq", 0xD3, v))
        else:
            out.append(struct.pack(">Bh", 0xD1, v) if v < -(1 << 7)
                       else struct.pack(">Bb", 0xD0, v))
    elif v < 1 << 7:
        out.append(struct.pack(">b", v))
    elif v < 1 << 16:
        out.append(struct.pack(">BB", 0xCC, v) if v < 1 << 8 else struct.pack(">BH", 0xCD, v))
    elif v < 1 << 32:
        out.append(struct.pack(">BI", 0xCE, v))
    elif v < 1 << 64:
        out.append(struct.pack(">BQ", 0xCF, v))
    else:
        raise OverflowError(f"integer {v} too large for msgpack")


def _pack(out: List[bytes], o: Any) -> None:
    if o is None:
        out.append(b"\xc0")
    elif o is True:
        out.append(b"\xc3")
    elif o is False:
        out.append(b"\xc2")
    elif isinstance(o, int):
        _pack_int(out, o)
    elif isinstance(o, float):
        out.append(struct.pack(">Bd", 0xCB, o))
    elif isinstance(o, str):
        raw = o.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(o, (list, tuple)):
        _head(out, len(o), 0x90, 16, (0, 0xDC, 0xDD))
        for x in o:
            _pack(out, x)
    elif isinstance(o, dict):
        _head(out, len(o), 0x80, 16, (0, 0xDE, 0xDF))
        for k, v in o.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def packb(o: Any) -> bytes:
    out: List[bytes] = []
    _pack(out, o)
    return b"".join(out)


_FIXED = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
        0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data truncated")
        b = self.data[self.pos: self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in _FIXED:
            return self.unpack(_FIXED[c])
        if c in _LEN:
            n = self.unpack(_LEN[c])
            if c <= 0xDB:
                return self.take(n).decode("utf-8")
            if c <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            out[k] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack value")
    return out
