"""A small MessagePack encoder and decoder for the index manifest.

Covers the types the v2 manifest uses: map, array, str, int, float, bool,
nil and bin.  ``packb`` writes what the ``msgpack`` package's ``packb``
writes by default for those types (smallest int encoding, float64, str
as UTF-8 str, bytes as bin); ``unpackb`` also reads float32 and any int
width.  Tuples pack as arrays; arrays unpack as lists.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, fix=(0xA0, 32), codes=(0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, fix=None, codes=(0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 16), codes=(None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 16), codes=(None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif 0 < n:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= hi:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too large for msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if n >= lo:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too small for msgpack")


def _pack_len(n: int, out: bytearray, *, fix, codes) -> None:
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} too large for msgpack")


_FIXED = {  # code -> (struct format, size) for numbers
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTHS = {  # code -> (kind, struct format of the length, size)
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def unpackb(data: bytes):
    obj, pos = _unpack(memoryview(bytes(data)), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after msgpack "
                         f"object")
    return obj


def _unpack(buf: memoryview, pos: int):
    if pos >= len(buf):
        raise ValueError("truncated msgpack data")
    code = buf[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code <= 0xBF:
        return _take(buf, pos, "str", code & 0x1F)
    if 0x90 <= code <= 0x9F:
        return _take(buf, pos, "array", code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _take(buf, pos, "map", code & 0x0F)
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        _need(buf, pos, size)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if code in _LENGTHS:
        kind, fmt, size = _LENGTHS[code]
        _need(buf, pos, size)
        n = struct.unpack_from(fmt, buf, pos)[0]
        return _take(buf, pos + size, kind, n)
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _need(buf: memoryview, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")


def _take(buf: memoryview, pos: int, kind: str, n: int):
    if kind in ("str", "bin"):
        _need(buf, pos, n)
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if kind == "str" else raw), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    obj = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        obj[k] = v
    return obj, pos
