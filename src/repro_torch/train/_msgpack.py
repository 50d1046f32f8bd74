"""A small msgpack codec for the ``.rpck`` checkpoint payload.

The machine with the GPU has no ``msgpack`` package, so the port carries
its own. It handles map, array, str, bin, int, float, bool and nil, and
chooses the smallest encoding of each value as
``msgpack.packb(obj, use_bin_type=True)`` does, so the two give the same
bytes; ``unpackb`` decodes str as UTF-8 (``raw=False``). Ext types are
not used by the format and are refused.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _head(n: int, fix: int, fix_max: int, code8, code16: int,
          code32: int, out: List[bytes]) -> None:
    """A length header: the fix form up to ``fix_max``, else the 8-bit
    form (where the type has one), else 16 or 32 bits."""
    if n <= fix_max:
        out.append(bytes((fix | n,)))
    elif code8 is not None and n <= 0xFF:
        out.append(bytes((code8, n)))
    elif n <= 0xFFFF:
        out.append(bytes((code16,)) + struct.pack(">H", n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes((code32,)) + struct.pack(">I", n))
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(len(data), 0xA0, 31, 0xD9, 0xDA, 0xDB, out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(len(data), 0, -1, 0xC4, 0xC5, 0xC6, out)
        out.append(data)
    elif isinstance(obj, dict):
        _head(len(obj), 0x80, 15, None, 0xDE, 0xDF, out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        _head(len(obj), 0x90, 15, None, 0xDC, 0xDD, out)
        for value in obj:
            _pack(value, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    if n > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= limit:
                return bytes((code,)) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if n >= limit:
                return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: integer {n} out of range")


# fixed-size values: type byte -> (struct format, size)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
          0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
          0xD3: (">q", 8)}
# length-prefixed values: type byte -> (kind, length format, its size)
_SIZED = {0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2),
          0xC6: ("bin", ">I", 4), 0xD9: ("str", ">B", 1),
          0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}


def unpackb(data: bytes) -> Any:
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(buf):
        raise ValueError("msgpack: truncated data")
    return buf[pos:pos + n]


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    code = _take(buf, pos, 1)[0]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack(fmt, _take(buf, pos, size))[0], pos + size
    if code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in _SIZED:
        kind, fmt, size = _SIZED[code]
        n = struct.unpack(fmt, _take(buf, pos, size))[0]
        pos += size
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")
    if kind in ("bin", "str"):
        raw = _take(buf, pos, n)
        return (bytes(raw) if kind == "bin"
                else str(raw, "utf-8")), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    return out, pos
