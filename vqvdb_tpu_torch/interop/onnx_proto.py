"""Minimal ONNX protobuf writer + parser (no `onnx` package dependency; a
copy of `vqvdb_tpu/interop/onnx_proto.py`, numpy only).

Implements exactly the ModelProto subset the exporter emits (see
onnx_export.py) using the protobuf wire format directly: varint (wire
type 0), 32-bit (5) and length-delimited (2) fields. Field numbers follow
the published onnx.proto3 schema.

The parser is intentionally independent of the writer's in-memory graph:
tests serialize with the writer, re-parse the *bytes* with the parser, and
execute the parsed graph (onnx_eval.py) — so a wire-format bug in either
half breaks the parity gate instead of cancelling out.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType values (onnx.proto3)
FLOAT = 1
UINT8 = 2
UINT16 = 4
INT32 = 6
INT64 = 7

_NP_OF = {FLOAT: np.float32, UINT8: np.uint8, UINT16: np.uint16,
          INT32: np.int32, INT64: np.int64}
DTYPE_OF = {np.dtype(np.float32): FLOAT, np.dtype(np.uint8): UINT8,
            np.dtype(np.uint16): UINT16, np.dtype(np.int32): INT32,
            np.dtype(np.int64): INT64}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS = 6, 7


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # two's-complement for negative int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field_no: int, wire: int) -> bytes:
    return _varint((field_no << 3) | wire)


def w_varint(field_no: int, value: int) -> bytes:
    return _key(field_no, 0) + _varint(value)


def w_bytes(field_no: int, data: bytes) -> bytes:
    return _key(field_no, 2) + _varint(len(data)) + data


def w_str(field_no: int, s: str) -> bytes:
    return w_bytes(field_no, s.encode("utf-8"))


def w_float(field_no: int, f: float) -> bytes:
    return _key(field_no, 5) + struct.pack("<f", f)


def w_packed_varints(field_no: int, values) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return w_bytes(field_no, payload)


# ---------------------------------------------------------------------------
# Message writers (structures defined in onnx_export.GraphBuilder)
# ---------------------------------------------------------------------------

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = DTYPE_OF[arr.dtype]
    msg = w_packed_varints(1, arr.shape)        # dims
    msg += w_varint(2, dt)                      # data_type
    msg += w_str(8, name)                       # name
    msg += w_bytes(9, arr.tobytes())            # raw_data (little-endian)
    return msg


def _attr(name: str, value) -> bytes:
    msg = w_str(1, name)
    if isinstance(value, float):
        msg += w_float(2, value) + w_varint(20, ATTR_FLOAT)
    elif isinstance(value, int):
        msg += w_varint(3, value) + w_varint(20, ATTR_INT)
    elif isinstance(value, str):
        msg += w_bytes(4, value.encode()) + w_varint(20, ATTR_STRING)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        msg += w_packed_varints(8, value) + w_varint(20, ATTR_INTS)
    elif isinstance(value, np.ndarray):
        msg += w_bytes(5, tensor_proto("", value)) + w_varint(20, ATTR_TENSOR)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return msg


def node_proto(op_type: str, inputs: List[str], outputs: List[str],
               name: str = "", **attrs) -> bytes:
    msg = b"".join(w_str(1, i) for i in inputs)
    msg += b"".join(w_str(2, o) for o in outputs)
    if name:
        msg += w_str(3, name)
    msg += w_str(4, op_type)
    msg += b"".join(w_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return msg


def value_info(name: str, elem_type: int, shape: List) -> bytes:
    """shape entries: int (dim_value) or str (dim_param, e.g. 'batch')."""
    dims = b""
    for d in shape:
        dim = w_varint(1, d) if isinstance(d, int) else w_str(2, d)
        dims += w_bytes(1, dim)
    tshape = dims
    ttype = w_varint(1, elem_type) + w_bytes(2, tshape)
    tp = w_bytes(1, ttype)  # TypeProto.tensor_type
    return w_str(1, name) + w_bytes(2, tp)


def graph_proto(name: str, nodes: List[bytes], initializers: List[bytes],
                inputs: List[bytes], outputs: List[bytes]) -> bytes:
    msg = b"".join(w_bytes(1, n) for n in nodes)
    msg += w_str(2, name)
    msg += b"".join(w_bytes(5, t) for t in initializers)
    msg += b"".join(w_bytes(11, i) for i in inputs)
    msg += b"".join(w_bytes(12, o) for o in outputs)
    return msg


def model_proto(graph: bytes, opset: int = 11, ir_version: int = 6,
                producer: str = "vqvdb_tpu") -> bytes:
    # The project's producer name in both packages, so their files are equal.
    msg = w_varint(1, ir_version)
    msg += w_str(2, producer)
    msg += w_bytes(7, graph)
    opset_id = w_str(1, "") + w_varint(2, opset)
    msg += w_bytes(8, opset_id)
    return msg


# ---------------------------------------------------------------------------
# Parser (wire bytes -> plain dataclasses)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value) over a message's wire bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field_no, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field_no, wire, val


def _unpack_varints(val, wire) -> List[int]:
    if wire == 0:
        return [val]
    out, pos = [], 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _signed64(v: int) -> int:
    """Protobuf varints carry int64 as two's complement; recover the sign."""
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class Tensor:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = FLOAT
    raw: bytes = b""
    vals: List = field(default_factory=list)  # typed *_data fields

    def to_numpy(self) -> np.ndarray:
        if not self.raw and self.vals:
            # Producers (torch among them) may use float_data/int64_data
            # instead of raw_data for small tensors.
            a = np.asarray(self.vals, dtype=_NP_OF[self.data_type])
        else:
            a = np.frombuffer(self.raw, dtype=_NP_OF[self.data_type])
        return a.reshape(self.dims)


@dataclass
class Attribute:
    name: str = ""
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[Tensor] = None
    ints: List[int] = field(default_factory=list)

    @property
    def value(self):
        for v in (self.f, self.i, self.s, self.t):
            if v is not None:
                return v
        return self.ints


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Attribute] = field(default_factory=dict)


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 0
    opset: int = 0
    producer: str = ""
    graph: Graph = field(default_factory=Graph)


def _parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    for no, wire, val in _fields(buf):
        if no == 1:
            t.dims.extend(_unpack_varints(val, wire))
        elif no == 2:
            t.data_type = val
        elif no == 4:  # float_data (packed 4-byte floats or repeated I32)
            if wire == 2:
                t.vals.extend(np.frombuffer(val, "<f4").tolist())
            else:
                t.vals.append(struct.unpack("<f", val)[0])
        elif no in (5, 7):  # int32_data / int64_data (packed varints)
            t.vals.extend(_signed64(v) for v in _unpack_varints(val, wire))
        elif no == 8:
            t.name = val.decode()
        elif no == 9:
            t.raw = val
    return t


def _parse_attr(buf: bytes) -> Attribute:
    a = Attribute()
    for no, wire, val in _fields(buf):
        if no == 1:
            a.name = val.decode()
        elif no == 2:
            a.f = struct.unpack("<f", val)[0]
        elif no == 3:
            a.i = _signed64(val)
        elif no == 4:
            a.s = val
        elif no == 5:
            a.t = _parse_tensor(val)
        elif no == 8:
            a.ints.extend(_signed64(v) for v in _unpack_varints(val, wire))
    return a


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for no, _, val in _fields(buf):
        if no == 1:
            n.inputs.append(val.decode())
        elif no == 2:
            n.outputs.append(val.decode())
        elif no == 3:
            n.name = val.decode()
        elif no == 4:
            n.op_type = val.decode()
        elif no == 5:
            a = _parse_attr(val)
            n.attrs[a.name] = a
    return n


def _vi_name(buf: bytes) -> str:
    for no, _, val in _fields(buf):
        if no == 1:
            return val.decode()
    return ""


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for no, _, val in _fields(buf):
        if no == 1:
            g.nodes.append(_parse_node(val))
        elif no == 2:
            g.name = val.decode()
        elif no == 5:
            t = _parse_tensor(val)
            g.initializers[t.name] = t.to_numpy()
        elif no == 11:
            g.inputs.append(_vi_name(val))
        elif no == 12:
            g.outputs.append(_vi_name(val))
    return g


def parse_model(buf: bytes) -> Model:
    m = Model()
    for no, _, val in _fields(buf):
        if no == 1:
            m.ir_version = val
        elif no == 2:
            m.producer = val.decode()
        elif no == 7:
            m.graph = _parse_graph(val)
        elif no == 8:
            for sno, _, sval in _fields(val):
                if sno == 2:
                    m.opset = sval
    return m
