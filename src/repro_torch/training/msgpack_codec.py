"""The subset of MessagePack that checkpoints use: maps, arrays, str, bin,
bool and integers.  Encoding picks the smallest form of each
value, as the ``msgpack`` package does with ``use_bin_type=True`` (bytes
are bin, str is str), so a tree encodes to the same bytes with either;
decoding reads every form and returns str as bytes (the package's
``raw=True``)."""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length-prefixed head: the fix form when n < fix_max, else the
    first of (code, width) whose width holds n."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 32, ((0xD9, ">B"), (0xDA, ">H"),
                                      (0xDB, ">I")))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _head(out, len(b), None, 0, ((0xC4, ">B"), (0xC5, ">H"),
                                     (0xC6, ">I")))
        out += b
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, ((0xDC, ">H"), (0xDD, ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, ((0xDE, ">H"), (0xDF, ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: {n} too large")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            lo = -(1 << (8 * struct.calcsize(fmt) - 1))
            if n >= lo:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: {n} too small")


# code -> (struct format of the fixed-width value or length, kind)
_FIXED = {0xCC: (">B", "num"), 0xCD: (">H", "num"), 0xCE: (">I", "num"),
          0xCF: (">Q", "num"), 0xD0: (">b", "num"), 0xD1: (">h", "num"),
          0xD2: (">i", "num"), 0xD3: (">q", "num"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError("msgpack: trailing bytes")
    return obj


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif c in (0xC2, 0xC3):
        return c == 0xC3, i
    elif c in _FIXED:
        fmt, kind = _FIXED[c]
        w = struct.calcsize(fmt)
        (n,) = struct.unpack_from(fmt, buf, i)
        i += w
        if kind == "num":
            return n, i
    else:
        raise ValueError(f"msgpack: unsupported type byte {c:#x}")
    if kind in ("str", "bin"):
        return bytes(buf[i:i + n]), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
