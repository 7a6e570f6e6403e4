"""Frozen reader of `VQMODEL1` model artifacts and of the msgpack subset
their params blob uses (flax's serializer).

Layout (little-endian): magic b"VQMODEL1", u32 config-JSON length and the
JSON, u64 params length and the msgpack params: nested maps of str keys
whose leaves are ext type 1 (an ndarray as the msgpack array
(shape, dtype name, raw bytes)) or ext type 3 (a numpy scalar). Convs are
stored DHWIO (kd, kh, kw, in, out), linears (in, out), GroupNorm as
scale / bias and the codebook as vq.embedding (K, D).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple, Union

import numpy as np

MAGIC = b"VQMODEL1"

_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Buf:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data truncated")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, raw = unpack(payload)
    dtype = np.dtype(dtype.decode() if isinstance(dtype, bytes) else dtype)
    return np.frombuffer(raw, dtype).reshape(shape).copy()


def _obj(b: _Buf) -> Any:
    tag = b.num(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return {_obj(b): _obj(b) for _ in range(tag & 0x0F)}
    if 0x90 <= tag <= 0x9F:
        return [_obj(b) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return b.take(tag & 0x1F).decode()
    if tag in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[tag]
    if tag in _FIXED:
        return b.num(_FIXED[tag])
    if tag in _FIXEXT or _SIZED.get(tag, ("",))[0] == "ext":
        n = _FIXEXT[tag] if tag in _FIXEXT else b.num(_SIZED[tag][1])
        code = b.num(">b")
        arr = _ndarray(b.take(n))
        return arr if code == 1 else arr[()]
    if tag in _SIZED:
        kind, fmt = _SIZED[tag]
        n = b.num(fmt)
        if kind == "bin":
            return b.take(n)
        if kind == "str":
            return b.take(n).decode()
        if kind == "array":
            return [_obj(b) for _ in range(n)]
        return {_obj(b): _obj(b) for _ in range(n)}
    raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")


def unpack(data: bytes) -> Any:
    b = _Buf(data)
    out = _obj(b)
    if b.pos != len(b.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load(path: Union[str, Path]) -> Tuple[Dict, Dict]:
    """(params: nested dict of numpy arrays, config: the JSON config block)."""
    raw = Path(path).read_bytes()
    if raw[:8] != MAGIC:
        raise ValueError(f"not a VQMODEL1 artifact: {path}")
    (n,) = struct.unpack_from("<I", raw, 8)
    config = json.loads(raw[12:12 + n].decode())
    (m,) = struct.unpack_from("<Q", raw, 12 + n)
    params = unpack(raw[20 + n:20 + n + m])
    return params, config
