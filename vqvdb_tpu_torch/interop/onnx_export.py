"""Emit encoder.onnx / decoder.onnx from a params tree (opset 11; counterpart
of `vqvdb_tpu/interop/onnx_export.py`, writing the same bytes).

Matches the reference deployment contract exactly (ref: python/to_onnx.py:
114-151 and the EncoderWrapper/DecoderWrapper at 19-43): graphs named by
file, I/O tensors named 'input'/'output', dynamic batch axis, encoder
returns uint8 codebook indices, decoder consumes them — so the emitted
files drop into the reference's ONNX-Runtime C++ backend unmodified.

No torch / onnx package involved: the graph is built op-by-op from the
reference-keyed state_dict (interop/torch_export.export_state_dict) and
serialized with the wire-level writer in onnx_proto.py. Ops used are all
opset-11 core: Conv, Relu, Sigmoid, Tanh, Add, Sub, Mul, Div, Sqrt,
ReduceMean, MatMul, Reshape, Transpose, Cast, Gather, ArgMin. GroupNorm
(not in opset 11) is decomposed into Reshape/ReduceMean arithmetic; the
3D pixel shuffle into Reshape/Transpose/Reshape with the reference's
(oc, rd, rh, rw) channel split (ref: python/VQVAE_v2.py:172-187).

The graphs work from the JAX-layout numpy tree (`core.artifact.load_model`;
the port's tensor tree is brought to it by `core.weights.params_to_jax`),
so for the same params the files are byte-identical to the JAX package's
(tests/test_torch_port_interop.py). The CLI's `export-onnx` re-parses and
executes them with onnx_eval.py and holds them to the port's
`encode_to_indices` / `decode_from_indices` at atol 1e-5 (the reference's
own validation threshold, to_onnx.py:208).

The packed TPU-co-designed encoders (ModelConfig.encoder_arch "packed" /
"packed_lite") export too: their space-to-channel pack is a
Reshape/Transpose/Reshape prelude and the rest is the same op vocabulary.
The I/O contract is unchanged — input (B, C, 8, 8, 8) floats, output
(B, 4, 4, 4) uint8/uint16 indices — so packed encoder.onnx files drop into
the reference's ONNX-Runtime backend exactly like reference-arch ones
(only torch-module export is reference-arch-only; see torch_export.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from vqvdb_tpu_torch.core.config import LATENT_DIM, ModelConfig
from vqvdb_tpu_torch.interop import onnx_proto as P
from vqvdb_tpu_torch.interop.torch_export import (
    _attn,
    _conv,
    _gn,
    _rb,
    decoder_quantizer_state_dict,
    export_state_dict,
    jax_layout,
)
from vqvdb_tpu_torch.models.vqvae import packed_encoder_width
from vqvdb_tpu_torch.utils.errors import ArtifactError

_L = LATENT_DIM  # 4


class _Builder:
    """Accumulates nodes/initializers; names values v0, v1, ..."""

    def __init__(self) -> None:
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._n = 0

    def fresh(self) -> str:
        self._n += 1
        return f"v{self._n}"

    def init(self, arr: np.ndarray, name: str = "") -> str:
        name = name or f"w{len(self.inits)}"
        self.inits.append(P.tensor_proto(name, np.ascontiguousarray(arr)))
        return name

    def op(self, op_type: str, inputs: List[str], out: str = "", **attrs) -> str:
        out = out or self.fresh()
        self.nodes.append(P.node_proto(op_type, inputs, [out], **attrs))
        return out

    # -- composite stages ---------------------------------------------------

    def const_scalar(self, v: float) -> str:
        return self.init(np.asarray([v], np.float32))

    def shape_const(self, dims: List[int]) -> str:
        return self.init(np.asarray(dims, np.int64))

    def conv(self, x: str, sd: Dict, key: str, *, stride: int = 1,
             pad: int = 0) -> str:
        w = self.init(sd[f"{key}.weight"], f"{key}.weight")
        ins = [x, w]
        if f"{key}.bias" in sd:
            ins.append(self.init(sd[f"{key}.bias"], f"{key}.bias"))
        k = sd[f"{key}.weight"].shape[2]
        return self.op("Conv", ins, strides=[stride] * 3, pads=[pad] * 6,
                       kernel_shape=[k] * 3)

    def group_norm(self, x: str, sd: Dict, key: str, groups: int,
                   channels: int, spatial: int, eps: float = 1e-5) -> str:
        r = self.op("Reshape", [x, self.shape_const([0, groups, -1])])
        mean = self.op("ReduceMean", [r], axes=[2], keepdims=1)
        d = self.op("Sub", [r, mean])
        var = self.op("ReduceMean", [self.op("Mul", [d, d])], axes=[2], keepdims=1)
        sdv = self.op("Sqrt", [self.op("Add", [var, self.const_scalar(eps)])])
        norm = self.op("Div", [d, sdv])
        back = self.op("Reshape", [norm, self.shape_const(
            [0, channels] + [spatial] * 3)])
        scale = self.init(sd[f"{key}.weight"].reshape(channels, 1, 1, 1),
                          f"{key}.weight")
        bias = self.init(sd[f"{key}.bias"].reshape(channels, 1, 1, 1),
                         f"{key}.bias")
        return self.op("Add", [self.op("Mul", [back, scale]), bias])

    def res_block(self, x: str, sd: Dict, key: str, channels: int,
                  spatial: int, groups: int = 8) -> str:
        # SAME padding derived per conv (the packed_lite encoder's RB has a
        # pointwise closer; everything else is k3) — mirrors
        # models/blocks.py residual_block.
        def same_pad(k: str) -> int:
            return (sd[f"{k}.weight"].shape[2] - 1) // 2

        h = self.op("Relu", [self.group_norm(x, sd, f"{key}.gn1", groups,
                                             channels, spatial)])
        h = self.conv(h, sd, f"{key}.conv1", pad=same_pad(f"{key}.conv1"))
        h = self.op("Relu", [self.group_norm(h, sd, f"{key}.gn2", groups,
                                             channels, spatial)])
        h = self.conv(h, sd, f"{key}.conv2", pad=same_pad(f"{key}.conv2"))
        return self.op("Add", [x, self.op("Mul", [h, self.const_scalar(0.1)])])

    def attention(self, x: str, sd: Dict, key: str, channels: int) -> str:
        m = self.op("ReduceMean", [x], axes=[2, 3, 4], keepdims=0)
        w1 = self.init(np.ascontiguousarray(sd[f"{key}.fc.0.weight"].T),
                       f"{key}.fc.0.wT")
        w2 = self.init(np.ascontiguousarray(sd[f"{key}.fc.2.weight"].T),
                       f"{key}.fc.2.wT")
        g = self.op("Relu", [self.op("MatMul", [m, w1])])
        g = self.op("Sigmoid", [self.op("MatMul", [g, w2])])
        g = self.op("Reshape", [g, self.shape_const([0, channels, 1, 1, 1])])
        return self.op("Mul", [x, g])

    def pixel_shuffle(self, x: str, oc: int, r: int, spatial: int) -> str:
        s = self.op("Reshape", [x, self.shape_const(
            [0, oc, r, r, r] + [spatial] * 3)])
        t = self.op("Transpose", [s], perm=[0, 1, 5, 2, 6, 3, 7, 4])
        return self.op("Reshape", [t, self.shape_const(
            [0, oc] + [spatial * r] * 3)])

    def model(self, name: str, in_vi: bytes, out_vi: bytes) -> bytes:
        g = P.graph_proto(name, self.nodes, self.inits, [in_vi], [out_vi])
        return P.model_proto(g)


def _packed_encoder_sd(params: Dict) -> Dict:
    """Torch-layout (OIDHW) numpy dict for the packed encoder's params.
    The packed graphs have no reference module tree, so the keys here are
    ours — stem.0/stem.1/res_stack.0/attn/proj in the reference's naming
    style — used only inside the emitted ONNX."""
    sd: Dict = {}
    enc = params["encoder"]
    if "pre_conv" in enc:  # packed_stem: 8^3 stage before the pack
        _conv(sd, "encoder.pre.0", enc["pre_conv"])
        _gn(sd, "encoder.pre.1", enc["pre_gn"])
    _conv(sd, "encoder.stem.0", enc["stem_conv"])
    _gn(sd, "encoder.stem.1", enc["stem_gn"])
    _rb(sd, "encoder.res_stack.0", enc["rb"])
    _attn(sd, "encoder.attn", enc["attn"])
    _conv(sd, "encoder.proj", enc["proj"])
    return sd


def _encoder_body_packed(b: _Builder, sd: Dict, cfg: ModelConfig,
                         x: str) -> str:
    """'input' (B, C, 8, 8, 8) -> latent z (B, D, 4, 4, 4) for the packed
    TPU-co-designed encoders; mirrors models/vqvae.py
    _encoder_features_packed stage-for-stage in NCDHW.

    space_to_channel in NCDHW: split each spatial dim as (coarse, parity),
    move the three parity axes next to C, and flatten — packed channel
    index = c*8 + a*4 + b*2 + c_off, identical to ops/packed.py's
    channels-last convention, so the DHWIO->OIDHW weight transpose is the
    only layout change."""
    c = cfg.in_channels
    w = packed_encoder_width(cfg)
    h = x
    if cfg.encoder_arch == "packed_stem":
        # 8^3 stem (conv k3 C -> W/8, GN, relu) before the pack; the pack
        # then lands on W channels and the trunk stem is pointwise (pad 0).
        s = w // 8
        h = b.conv(h, sd, "encoder.pre.0", pad=1)
        h = b.op("Relu", [b.group_norm(h, sd, "encoder.pre.1", s // 2, s, 8)])
        c = s
    h = b.op("Reshape", [h, b.shape_const([0, c, _L, 2, _L, 2, _L, 2])])
    h = b.op("Transpose", [h], perm=[0, 1, 3, 5, 7, 2, 4, 6])
    h = b.op("Reshape", [h, b.shape_const([0, c * 8] + [_L] * 3)])
    stem_pad = 0 if cfg.encoder_arch == "packed_stem" else 1
    h = b.conv(h, sd, "encoder.stem.0", pad=stem_pad)
    h = b.op("Relu", [b.group_norm(h, sd, "encoder.stem.1", 8, w, _L)])
    h = b.res_block(h, sd, "encoder.res_stack.0", w, _L)
    h = b.attention(h, sd, "encoder.attn", w)
    return b.conv(h, sd, "encoder.proj")


def _encoder_body(b: _Builder, sd: Dict, cfg: ModelConfig, x: str) -> str:
    """'input' -> latent z (B, D, 4, 4, 4); mirrors models/vqvae.py
    encoder_apply stage-for-stage."""
    if cfg.encoder_arch.startswith("packed"):
        return _encoder_body_packed(b, sd, cfg, x)
    if cfg.variant == "scalar":
        h = b.conv(x, sd, "encoder.pre.0", pad=1)
        h = b.op("Relu", [b.group_norm(h, sd, "encoder.pre.1", 4, 16, 8)])
        h = b.res_block(h, sd, "encoder.pre.3", 16, 8)
        h = b.conv(h, sd, "encoder.down", stride=2, pad=1)
        h = b.res_block(h, sd, "encoder.res_stack.0", 32, _L)
        h = b.attention(h, sd, "encoder.attn", 32)
    else:
        h = b.conv(x, sd, "encoder.pre.0", pad=1)
        h = b.op("Relu", [b.group_norm(h, sd, "encoder.pre.1", 8, 64, 8)])
        h = b.res_block(h, sd, "encoder.pre.3", 64, 8)
        h = b.conv(h, sd, "encoder.down1", stride=2, pad=1)
        h = b.res_block(h, sd, "encoder.res_stack.0", 128, _L)
        h = b.res_block(h, sd, "encoder.res_stack.1", 128, _L)
        h = b.attention(h, sd, "encoder.attn", 128)
    return b.conv(h, sd, "encoder.proj")


def _decoder_body(b: _Builder, sd: Dict, cfg: ModelConfig, z: str) -> str:
    """latent (B, D, 4, 4, 4) -> pre-activation reconstruction."""
    if cfg.variant == "scalar":
        h = b.conv(z, sd, "decoder.stem.0", pad=1)
        h = b.op("Relu", [b.group_norm(h, sd, "decoder.stem.1", 8, 64, _L)])
        h = b.res_block(h, sd, "decoder.res_stack.0", 64, _L)
        h = b.attention(h, sd, "decoder.attn", 64)
    else:
        h = b.conv(z, sd, "decoder.stem.0", pad=1)
        h = b.op("Relu", [b.group_norm(h, sd, "decoder.stem.1", 8, 128, _L)])
        h = b.res_block(h, sd, "decoder.res_stack.0", 128, _L)
        h = b.res_block(h, sd, "decoder.res_stack.1", 128, _L)
        h = b.attention(h, sd, "decoder.attn", 128)
    h = b.conv(h, sd, "decoder.up_conv", pad=1)
    h = b.pixel_shuffle(h, 32, 2, _L)
    return b.conv(h, sd, "decoder.final", pad=1)


def _index_onnx_dtype(cfg: ModelConfig) -> int:
    # uint8 matches the reference wrappers (to_onnx.py:26-43); our v4
    # extension (K > 256) needs uint16.
    return P.UINT8 if cfg.num_embeddings <= 256 else P.UINT16


def _state_dict(params: Dict, cfg: ModelConfig) -> Dict:
    params = jax_layout(params)
    if cfg.encoder_arch.startswith("packed"):
        sd = decoder_quantizer_state_dict(params, cfg)
        sd.update(_packed_encoder_sd(params))
        return sd
    return export_state_dict(params, cfg)


def build_encoder_onnx(params: Dict, cfg: ModelConfig) -> bytes:
    sd = _state_dict(params, cfg)
    b = _Builder()
    z = _encoder_body(b, sd, cfg, "input")
    t = b.op("Transpose", [z], perm=[0, 2, 3, 4, 1])
    flat = b.op("Reshape", [t, b.shape_const([-1, cfg.embedding_dim])])
    emb = sd["quantizer.embedding"]  # (K, D)
    scores = b.op("MatMul", [flat, b.init(np.ascontiguousarray(emb.T), "embT")])
    dist = b.op("Add", [b.op("Mul", [scores, b.const_scalar(-2.0)]),
                        b.init((emb * emb).sum(1), "emb_sq")])
    idx = b.op("ArgMin", [dist], axis=1, keepdims=0)
    idx = b.op("Reshape", [idx, b.shape_const([-1] + [_L] * 3)])
    b.op("Cast", [idx], out="output", to=_index_onnx_dtype(cfg))
    in_vi = P.value_info("input", P.FLOAT,
                         ["batch_size", cfg.in_channels, 8, 8, 8])
    out_vi = P.value_info("output", _index_onnx_dtype(cfg),
                          ["batch_size", _L, _L, _L])
    return b.model("vqvdb_encoder", in_vi, out_vi)


def build_decoder_onnx(params: Dict, cfg: ModelConfig) -> bytes:
    sd = _state_dict(params, cfg)
    b = _Builder()
    idx = b.op("Cast", ["input"], to=P.INT64)
    q = b.op("Gather", [b.init(sd["quantizer.embedding"], "embedding"), idx],
             axis=0)  # (B, 4, 4, 4, D)
    z = b.op("Transpose", [q], perm=[0, 4, 1, 2, 3])
    h = _decoder_body(b, sd, cfg, z)
    act = "Sigmoid" if cfg.variant == "scalar" else "Tanh"
    b.op(act, [h], out="output")
    in_vi = P.value_info("input", _index_onnx_dtype(cfg),
                         ["batch_size", _L, _L, _L])
    out_vi = P.value_info("output", P.FLOAT,
                          ["batch_size", cfg.in_channels, 8, 8, 8])
    return b.model("vqvdb_decoder", in_vi, out_vi)


def export_onnx(out_dir: Union[str, Path], params: Dict,
                cfg: ModelConfig) -> Dict[str, str]:
    """Write encoder.onnx + decoder.onnx (the file names the reference
    runtime looks for) into out_dir; returns the paths."""
    if cfg.num_quantizers != 1:
        raise ArtifactError(
            "ONNX export targets the reference runtime, which supports a "
            "single quantizer stage; residual-VQ models cannot be exported")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    enc, dec = out / "encoder.onnx", out / "decoder.onnx"
    enc.write_bytes(build_encoder_onnx(params, cfg))
    dec.write_bytes(build_decoder_onnx(params, cfg))
    return {"encoder": str(enc), "decoder": str(dec)}
