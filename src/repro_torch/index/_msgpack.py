"""The subset of MessagePack the index header uses, with no dependency.

`packb(obj)` is byte-identical to `msgpack.packb(obj, use_bin_type=True)`
and `unpackb(data)` returns what `msgpack.unpackb(data, raw=False,
strict_map_key=False)` returns, for the types a builder header holds:
dict, list/tuple, str, bytes, bool, None, float (packed as float64) and
int from -2**63 to 2**64 - 1. Anything else raises `TypeError`, as
msgpack itself does for a type it has no packer for.

Encoding rules (the MessagePack spec, smallest form first, as msgpack's
packer picks them): positive fixint / uint8..64 for non-negative ints,
negative fixint / int8..64 for negative ones; fixstr / str8..32;
bin8..32; fixarray / array16..32; fixmap / map16..32; dicts keep their
insertion order.
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
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes((0xD9, n))
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n <= 0xFF:
            out += bytes((0xC4, n))
        elif n <= 0xFFFF:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 0xDC, 0xDD, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_len(n: int, fix: int, code16: int, code32: int,
              out: bytearray) -> None:
    if n <= 0x0F:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.append(code16)
        out += struct.pack(">H", n)
    else:
        out.append(code32)
        out += struct.pack(">I", n)


def _pack_int(x: int, out: bytearray) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(x)
        elif x <= 0xFF:
            out += bytes((0xCC, x))
        elif x <= 0xFFFF:
            out.append(0xCD)
            out += struct.pack(">H", x)
        elif x <= 0xFFFFFFFF:
            out.append(0xCE)
            out += struct.pack(">I", x)
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out.append(0xCF)
            out += struct.pack(">Q", x)
        else:
            raise OverflowError("int too big to convert")
    elif x >= -32:
        out.append(x & 0xFF)
    elif x >= -0x80:
        out.append(0xD0)
        out += struct.pack(">b", x)
    elif x >= -0x8000:
        out.append(0xD1)
        out += struct.pack(">h", x)
    elif x >= -0x80000000:
        out.append(0xD2)
        out += struct.pack(">i", x)
    elif x >= -0x8000000000000000:
        out.append(0xD3)
        out += struct.pack(">q", x)
    else:
        raise OverflowError("int too big to convert")


# fixed-width scalars: first byte -> (struct format, byte count)
_SCALARS = {
    0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# variable-length heads: first byte -> (kind, length-field format, bytes)
_SIZED = {
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def unpackb(data: bytes):
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError(f"extra data: {len(view) - pos} trailing bytes")
    return obj


def _unpack(view: memoryview, pos: int):
    if pos >= len(view):
        raise ValueError("truncated msgpack data")
    b = view[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _take(view, pos, b & 0x1F, "str")
    if 0x90 <= b <= 0x9F:
        return _container(view, pos, b & 0x0F, "array")
    if 0x80 <= b <= 0x8F:
        return _container(view, pos, b & 0x0F, "map")
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _SCALARS:
        fmt, size = _SCALARS[b]
        _need(view, pos, size)
        return struct.unpack_from(fmt, view, pos)[0], pos + size
    if b in _SIZED:
        kind, fmt, size = _SIZED[b]
        _need(view, pos, size)
        n = struct.unpack_from(fmt, view, pos)[0]
        pos += size
        if kind in ("str", "bin"):
            return _take(view, pos, n, kind)
        return _container(view, pos, n, kind)
    raise TypeError(f"unsupported msgpack type byte 0x{b:02x}")


def _need(view: memoryview, pos: int, n: int) -> None:
    if pos + n > len(view):
        raise ValueError("truncated msgpack data")


def _take(view: memoryview, pos: int, n: int, kind: str):
    _need(view, pos, n)
    raw = bytes(view[pos:pos + n])
    return (raw.decode("utf-8") if kind == "str" else raw), pos + n


def _container(view: memoryview, pos: int, n: int, kind: str):
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(view, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(view, pos)
        v, pos = _unpack(view, pos)
        out[k] = v
    return out, pos
