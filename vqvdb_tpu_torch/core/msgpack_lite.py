"""A small msgpack codec for the subset flax's serializer writes.

The `.vqmodel` params blob is `flax.serialization.to_bytes` output: nested
maps of str keys whose leaves are msgpack ext type 1 (an ndarray, itself a
msgpack array `(shape, dtype_name, raw_bytes)`). The machines that run this
package carry no `msgpack` package, so this module reads and writes the
format itself.

`unpackb` decodes maps, arrays, str, bin, nil/bool, ints, floats and ext
types 1 (ndarray) and 3 (numpy scalar). Anything else, a truncated buffer,
or trailing bytes raise ValueError.

`packb` encodes what `to_bytes` encodes for a params tree, byte for byte:
maps in their dicts' key order, each value in msgpack's shortest form
(msgpack-python's choices with `use_bin_type=True`), Python floats as
doubles, C-contiguous ndarrays as ext 1 and numpy scalars as ext 3.
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


# flax splits an array above this many bytes into chunks; no params leaf of
# this package comes near it, so `packb` refuses one rather than chunk it.
MAX_ARRAY_BYTES = 2**30


def _head(out: bytearray, n: int, fix: int, fix_max: int, tags: tuple) -> None:
    """A length header: the fix form below fix_max, else the first of
    (tag 8 bit, tag 16 bit, tag 32 bit) that holds n (None: no 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif tags[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", tags[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", tags[1], n)
    else:
        out += struct.pack(">BI", tags[2], n)


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xFF, ">BB", 0xCC), (0xFFFF, ">BH", 0xCD),
             (0xFFFFFFFF, ">BI", 0xCE), (2**64 - 1, ">BQ", 0xCF)) if v > 0 else \
        ((-2**7, ">Bb", 0xD0), (-2**15, ">Bh", 0xD1), (-2**31, ">Bi", 0xD2),
         (-2**63, ">Bq", 0xD3))
    for limit, fmt, tag in forms:
        if (v <= limit) if v > 0 else (v >= limit):
            out += struct.pack(fmt, tag, v)
            return
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _ext_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot pack an ndarray of dtype {arr.dtype}")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"ndarray of {arr.nbytes} bytes exceeds {MAX_ARRAY_BYTES}")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _encode(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), None, -1, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _encode(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _encode(out, k)
            _encode(out, v)
    elif isinstance(obj, (np.ndarray, np.generic)):
        payload = _ext_payload(np.asarray(obj))
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _head(out, n, None, -1, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
        out += payload
    else:
        raise ValueError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode `obj` (dicts, lists, tuples, str, bytes, ints, floats, bools,
    None, ndarrays and numpy scalars) as msgpack."""
    out = bytearray()
    _encode(out, obj)
    return bytes(out)
