"""Reference numpy evaluator for the exported ONNX graphs (a copy of
`vqvdb_tpu/interop/onnx_eval.py`: numpy only, opset 11).

The environment has no onnxruntime, so the export parity gate (the
reference validates ONNX output against the source model at atol 1e-5,
ref: python/to_onnx.py:185-219) is implemented here: parse the serialized
bytes with onnx_proto.parse_model and execute the graph with numpy,
op-for-op per the ONNX operator spec. The opset-11 subset covers both the
graphs our exporter emits and the graphs `torch.onnx.export` produces for
the same architecture (Constant/InstanceNormalization/Shape/Unsqueeze/
ReduceSum come from torch's GroupNorm and attention decompositions —
the JAX package's tests/test_torch_onnx_cross.py runs torch-produced bytes through this
executor as the independent-producer gate); unknown ops raise.

This doubles as a wire-format check — a serialization bug surfaces as a
parse or numerics failure here rather than only inside ORT at deploy time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np

from vqvdb_tpu_torch.interop import onnx_proto as P

_CAST_NP = {P.FLOAT: np.float32, P.UINT8: np.uint8, P.UINT16: np.uint16,
            P.INT32: np.int32, P.INT64: np.int64}


def _conv3d(x: np.ndarray, w: np.ndarray, b, strides, pads) -> np.ndarray:
    # pads: [d0, h0, w0, d1, h1, w1]
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[3]), (pads[1], pads[4]),
                   (pads[2], pads[5])))
    kd, kh, kw = w.shape[2:]
    win = np.lib.stride_tricks.sliding_window_view(x, (kd, kh, kw),
                                                   axis=(2, 3, 4))
    sd, sh, sw = strides
    win = win[:, :, ::sd, ::sh, ::sw]
    y = np.einsum("bcxyzijk,ocijk->boxyz", win, w, optimize=True)
    if b is not None:
        y = y + b[None, :, None, None, None]
    return np.ascontiguousarray(y.astype(np.float32))


def _reshape(x: np.ndarray, shape: np.ndarray) -> np.ndarray:
    tgt = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
    return x.reshape(tgt)


def run_graph(graph: P.Graph, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    env: Dict[str, np.ndarray] = dict(graph.initializers)
    env.update(feeds)
    for n in graph.nodes:
        i = [env[name] for name in n.inputs]
        a = {k: v.value for k, v in n.attrs.items()}
        if n.op_type == "Constant":
            y = a["value"].to_numpy()
        elif n.op_type == "Identity":
            y = i[0]
        elif n.op_type == "Conv":
            bias = i[2] if len(i) > 2 else None
            y = _conv3d(i[0], i[1], bias, a.get("strides", [1] * 3),
                        a.get("pads", [0] * 6))
        elif n.op_type == "Relu":
            y = np.maximum(i[0], 0)
        elif n.op_type == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-i[0].astype(np.float64)))
            y = y.astype(np.float32)
        elif n.op_type == "Tanh":
            y = np.tanh(i[0])
        elif n.op_type == "Sqrt":
            y = np.sqrt(i[0])
        elif n.op_type == "Add":
            y = i[0] + i[1]
        elif n.op_type == "Sub":
            y = i[0] - i[1]
        elif n.op_type == "Mul":
            y = i[0] * i[1]
        elif n.op_type == "Div":
            y = i[0] / i[1]
        elif n.op_type == "ReduceMean":
            y = i[0].mean(axis=tuple(a["axes"]),
                          keepdims=bool(a.get("keepdims", 1)))
            y = y.astype(i[0].dtype)
        elif n.op_type == "ReduceSum":
            y = i[0].sum(axis=tuple(a["axes"]),
                         keepdims=bool(a.get("keepdims", 1)))
            y = y.astype(i[0].dtype)
        elif n.op_type == "InstanceNormalization":
            x, scale, bias = i
            axes = tuple(range(2, x.ndim))
            mean = x.mean(axis=axes, keepdims=True)
            var = x.var(axis=axes, keepdims=True)  # biased, per spec
            shp = (1, -1) + (1,) * (x.ndim - 2)
            y = (scale.reshape(shp) * (x - mean)
                 / np.sqrt(var + a.get("epsilon", 1e-5))
                 + bias.reshape(shp)).astype(np.float32)
        elif n.op_type == "Shape":
            y = np.asarray(i[0].shape, np.int64)
        elif n.op_type == "Unsqueeze":
            y = i[0]
            for ax in sorted(a["axes"]):
                y = np.expand_dims(y, ax)
        elif n.op_type == "MatMul":
            y = i[0] @ i[1]
        elif n.op_type == "Reshape":
            y = _reshape(i[0], i[1])
        elif n.op_type == "Transpose":
            y = np.transpose(i[0], a["perm"])
        elif n.op_type == "Cast":
            y = i[0].astype(_CAST_NP[a["to"]])
        elif n.op_type == "Gather":
            y = np.take(i[0], i[1].astype(np.int64), axis=a.get("axis", 0))
        elif n.op_type == "ArgMin":
            y = np.argmin(i[0], axis=a.get("axis", 0)).astype(np.int64)
            if a.get("keepdims", 1):
                y = np.expand_dims(y, a.get("axis", 0))
        else:
            raise NotImplementedError(f"op {n.op_type}")
        env[n.outputs[0]] = y
    return {name: env[name] for name in graph.outputs}


def run_model(model: Union[bytes, str, Path],
              feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Parse serialized ONNX bytes (or a path) and execute."""
    if not isinstance(model, (bytes, bytearray)):
        model = Path(model).read_bytes()
    return run_graph(P.parse_model(bytes(model)).graph, feeds)
