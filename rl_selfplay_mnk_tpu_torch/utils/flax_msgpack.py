"""Reader and writer of the JAX package's weight files: flax's msgpack bytes.

``flax.serialization.to_bytes`` writes a variables tree as one msgpack value:
nested maps with string keys whose leaves are arrays, each array a msgpack
extension of type 1 that holds a nested msgpack array
``[shape, dtype name, row-major bytes]`` (type 3 is the same for a numpy
scalar). This module packs and unpacks that subset of msgpack (nil, bool,
int, float, str, bin, array, map, ext) with numpy arrays as the leaves, and
picks each value's shortest encoding and writes a map's keys in sorted order
(the order in which the JAX package's exporter hands its trees to flax), so a
tree written here has the bytes of that package's export of it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class MsgpackError(ValueError):
    """The bytes are not the msgpack subset that flax writes."""


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
                             (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
        if 0 <= n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    for limit, code, fmt in ((0x80, 0xD0, ">b"), (0x8000, 0xD1, ">h"), (0x80000000, 0xD2, ">i"),
                             (0x8000000000000000, 0xD3, ">q")):
        if -limit <= n < 0:
            return bytes([code]) + struct.pack(fmt, n)
    raise MsgpackError(f"integer {n} does not fit 64 bits")


def _sized(n: int, fix, codes) -> bytes:
    """The header of a str, bin, array or map of ``n`` items: ``fix`` is
    (base byte, most items) of the one-byte form or None, ``codes`` the type
    bytes of the 8-, 16- and 32-bit forms (None where there is none)."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, limit, fmt in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF), (">B", ">H", ">I")):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise MsgpackError(f"{n} items are too many for msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return bytes([fixed[len(data)], code]) + data
    return _sized(len(data), None, (0xC7, 0xC8, 0xC9)) + bytes([code]) + data


def packb(value: Any) -> bytes:
    """``value`` (dicts with str keys, lists, str, bytes, int, float, bool,
    None, numpy arrays) as msgpack bytes."""
    if value is None:
        return b"\xc0"
    if isinstance(value, bool):
        return b"\xc3" if value else b"\xc2"
    if isinstance(value, int):
        return _pack_int(value)
    if isinstance(value, float):
        return b"\xcb" + struct.pack(">d", value)
    if isinstance(value, str):
        raw = value.encode("utf-8")
        return _sized(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(value, (bytes, bytearray)):
        return _sized(len(value), None, (0xC4, 0xC5, 0xC6)) + bytes(value)
    if isinstance(value, (list, tuple)):
        return _sized(len(value), (0x90, 15), (None, 0xDC, 0xDD)) + b"".join(map(packb, value))
    if isinstance(value, dict):
        # Keys in sorted order at every level, as the JAX package's exports have them.
        items = b"".join(packb(k) + packb(v) for k, v in sorted(value.items()))
        return _sized(len(value), (0x80, 15), (None, 0xDE, 0xDF)) + items
    if isinstance(value, np.generic):
        return _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(value)))
    if isinstance(value, np.ndarray):
        return _pack_ext(EXT_NDARRAY, _array_payload(value))
    raise MsgpackError(f"cannot pack a {type(value).__name__}")


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise MsgpackError(f"dtype {arr.dtype} is not a plain array type")
    return packb((tuple(int(n) for n in arr.shape), arr.dtype.name, arr.tobytes("C")))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

_FIXED = {  # type byte -> struct format of a scalar
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LENGTH = {  # type byte -> (kind, struct format of the length)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _take(data: memoryview, at: int, n: int) -> Tuple[memoryview, int]:
    if at + n > len(data):
        raise MsgpackError("the msgpack bytes end inside a value")
    return data[at:at + n], at + n


def _unpack_ext(code: int, payload: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise MsgpackError(f"unknown msgpack extension type {code}")
    shape, dtype_name, buffer = unpackb(payload)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as exc:
        raise MsgpackError(f"unsupported array dtype {dtype_name!r}") from exc
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def _unpack(data: memoryview, at: int):
    (tag,), at = _take(data, at, 1)
    if tag < 0x80:
        return tag, at
    if tag >= 0xE0:
        return tag - 0x100, at
    if tag in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[tag], at
    if tag in _FIXED:
        raw, at = _take(data, at, struct.calcsize(_FIXED[tag]))
        return struct.unpack(_FIXED[tag], raw)[0], at
    if tag in _FIXEXT:
        (code,), at = _take(data, at, 1)
        payload, at = _take(data, at, _FIXEXT[tag])
        return _unpack_ext(code, payload), at
    if 0xA0 <= tag < 0xC0:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag < 0xA0:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag < 0x90:
        kind, n = "map", tag & 0x0F
    elif tag in _LENGTH:
        kind, fmt = _LENGTH[tag]
        raw, at = _take(data, at, struct.calcsize(fmt))
        n = struct.unpack(fmt, raw)[0]
    else:
        raise MsgpackError(f"unknown msgpack type byte 0x{tag:02x}")
    if kind == "ext":
        (code,), at = _take(data, at, 1)
        payload, at = _take(data, at, n)
        return _unpack_ext(code, payload), at
    if kind in ("str", "bin"):
        raw, at = _take(data, at, n)
        return (str(raw, "utf-8") if kind == "str" else bytes(raw)), at
    if kind == "array":
        out = []
        for _ in range(n):
            item, at = _unpack(data, at)
            out.append(item)
        return out, at
    out = {}
    for _ in range(n):
        key, at = _unpack(data, at)
        out[key], at = _unpack(data, at)
    return out, at


def unpackb(data) -> Any:
    """The value that msgpack ``data`` holds, arrays as numpy arrays."""
    view = memoryview(data)
    value, at = _unpack(view, 0)
    if at != len(view):
        raise MsgpackError(f"{len(view) - at} bytes follow the msgpack value")
    return value
