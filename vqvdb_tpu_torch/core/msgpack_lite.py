"""A small msgpack decoder for the subset flax's serializer writes.

The `.vqmodel` params blob is `flax.serialization.to_bytes` output: nested
maps of str keys whose leaves are msgpack ext type 1 (an ndarray, itself a
msgpack array `(shape, dtype_name, raw_bytes)`). The machines that run this
package carry no `msgpack` package, so this module decodes the format
itself: maps, arrays, str, bin, nil/bool, ints, floats and ext types 1
(ndarray) and 3 (numpy scalar). Anything else, a truncated buffer, or
trailing bytes raise ValueError.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise ValueError(
                f"msgpack data truncated: need {n} bytes at offset "
                f"{self.pos}, have {len(self.buf) - self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# Fixed-width types: tag -> struct format (big-endian, as msgpack stores).
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# Variable-length types: tag -> (kind, struct format of the length).
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(r: _Reader) -> Any:
    tag = r.unpack(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _map(r, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return [_decode(r) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return _str(r, tag & 0x1F)
    if tag == 0xC0:
        return None
    if tag in (0xC2, 0xC3):
        return tag == 0xC3
    if tag in _SCALARS:
        return r.unpack(_SCALARS[tag])
    if tag in _FIXEXT:
        return _ext(r, _FIXEXT[tag])
    if tag in _SIZED:
        kind, fmt = _SIZED[tag]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return _str(r, n)
        if kind == "ext":
            return _ext(r, n)
        if kind == "array":
            return [_decode(r) for _ in range(n)]
        return _map(r, n)
    raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")


def _str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    return out


def _ext(r: _Reader, n: int) -> Any:
    code = r.unpack(">b")
    payload = bytes(r.take(n))
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    arr = _ndarray(payload)
    return arr if code == EXT_NDARRAY else arr[()]


def _ndarray(payload: bytes) -> np.ndarray:
    spec = unpackb(payload)
    if not (isinstance(spec, list) and len(spec) == 3):
        raise ValueError("malformed ndarray ext payload")
    shape, dtype_name, raw = spec
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"unsupported ndarray dtype {dtype_name!r}") from e
    count = int(np.prod(shape, dtype=np.int64))
    if not isinstance(raw, bytes) or len(raw) != count * dtype.itemsize:
        raise ValueError(
            f"ndarray payload holds {len(raw)} bytes, shape {shape} of "
            f"{dtype_name} needs {count * dtype.itemsize}")
    return np.frombuffer(raw, dtype).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of `data`."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(
            f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return obj
