"""Export a params tree to reference-layout torch artifacts (counterpart of
`vqvdb_tpu/interop/torch_export.py`, the same keys and arrays).

Exact inverse of core/torch_import.py's key/layout mapping:

  JAX layout                          ->  torch layout
    conv w (kD, kH, kW, I, O) [DHWIO] ->  Conv3d.weight (O, I, kD, kH, kW)
    gn scale/bias (C,)                ->  GroupNorm.weight/bias
    linear w (in, out)                ->  Linear.weight (out, in)
    vq {embedding, cluster_size, embed_avg} -> quantizer.*

Every function takes the port's params tree (torch tensors, as
`core.weights.params_from_jax` and training make it), which
`core.weights.params_to_jax` brings to the JAX layout, or that JAX-layout
numpy tree itself (`core.artifact.load_model`). Three artifact forms:
  * export_state_dict         — in-memory reference-keyed dict of numpy arrays
  * save_reference_checkpoint — .pth shaped like the reference trainer's
    checkpoints ({"epoch", "state_dict"}), read back by core/torch_import.py
  * save_torchscript          — scripted .pt with encode/decode methods, the
    input of the reference's ONNX converter (python/to_onnx.py:46-56)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch

from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.weights import params_to_jax


def jax_layout(params: Dict) -> Dict:
    """The port's params tree -> the JAX-layout numpy tree; a numpy tree
    passes through."""
    if isinstance(params["vq"]["embedding"], torch.Tensor):
        return params_to_jax(params)
    return params


def _conv(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    w = np.asarray(p["w"], np.float32)
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))
    if "b" in p:
        out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _gn(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"], np.float32)
    out[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _rb(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    _gn(out, f"{prefix}.gn1", p["gn1"])
    _conv(out, f"{prefix}.conv1", p["conv1"])
    _gn(out, f"{prefix}.gn2", p["gn2"])
    _conv(out, f"{prefix}.conv2", p["conv2"])


def _attn(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.fc.0.weight"] = np.ascontiguousarray(
        np.asarray(p["fc1"]["w"], np.float32).T)
    out[f"{prefix}.fc.2.weight"] = np.ascontiguousarray(
        np.asarray(p["fc2"]["w"], np.float32).T)


def export_state_dict(params: Dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Params -> reference-keyed state_dict of float32 numpy arrays."""
    if cfg.num_quantizers != 1:
        raise ValueError(
            "torch export targets the reference layout, which has a single "
            "quantizer stage; residual-VQ models cannot be exported")
    if cfg.encoder_arch != "reference":
        raise ValueError(
            "torch export targets the reference module tree; the packed "
            "(TPU-co-designed) encoder has no torch counterpart")
    params = jax_layout(params)
    sd: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    _conv(sd, "encoder.pre.0", enc["pre_conv"])
    _gn(sd, "encoder.pre.1", enc["pre_gn"])
    _rb(sd, "encoder.pre.3", enc["pre_rb"])
    if cfg.variant == "scalar":
        _conv(sd, "encoder.down", enc["down"])
        _rb(sd, "encoder.res_stack.0", enc["rb"])
    else:
        _conv(sd, "encoder.down1", enc["down"])
        _rb(sd, "encoder.res_stack.0", enc["rb1"])
        _rb(sd, "encoder.res_stack.1", enc["rb2"])
    _attn(sd, "encoder.attn", enc["attn"])
    _conv(sd, "encoder.proj", enc["proj"])
    sd.update(decoder_quantizer_state_dict(params, cfg))
    return sd


def decoder_quantizer_state_dict(params: Dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Reference-keyed decoder + quantizer entries only. The decoder graph
    is shared by every encoder_arch, so the ONNX exporter reuses this for
    packed models that export_state_dict rejects."""
    params = jax_layout(params)
    sd: Dict[str, np.ndarray] = {}
    dec = params["decoder"]
    _conv(sd, "decoder.stem.0", dec["stem_conv"])
    _gn(sd, "decoder.stem.1", dec["stem_gn"])
    if cfg.variant == "scalar":
        _rb(sd, "decoder.res_stack.0", dec["rb"])
    else:
        _rb(sd, "decoder.res_stack.0", dec["rb1"])
        _rb(sd, "decoder.res_stack.1", dec["rb2"])
    _attn(sd, "decoder.attn", dec["attn"])
    _conv(sd, "decoder.up_conv", dec["up_conv"])
    _conv(sd, "decoder.final", dec["final"])
    vq = params["vq"]
    sd["quantizer.embedding"] = np.asarray(vq["embedding"], np.float32)
    sd["quantizer.cluster_size"] = np.asarray(vq["cluster_size"], np.float32)
    sd["quantizer.embed_avg"] = np.asarray(vq["embed_avg"], np.float32)
    return sd


def _torch_state_dict(params: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in export_state_dict(params, cfg).items()}


def save_reference_checkpoint(path: Union[str, Path], params: Dict,
                              cfg: ModelConfig, *, epoch: int = 0) -> None:
    """Write a .pth in the reference trainer's checkpoint shape: a dict with
    a "state_dict" entry of CPU tensors. core/torch_import.py reads it back
    losslessly."""
    torch.save({"epoch": epoch, "state_dict": _torch_state_dict(params, cfg)}, str(path))


def save_torchscript(path: Union[str, Path], params: Dict, cfg: ModelConfig) -> None:
    """Write a TorchScript .pt (on the CPU) exposing encode/decode — the
    artifact the reference ONNX converter loads with torch.jit.load."""
    from vqvdb_tpu_torch.interop.torch_module import build_torch_vqvae

    module = build_torch_vqvae(cfg)
    module.load_state_dict(_torch_state_dict(params, cfg), strict=True)
    torch.jit.script(module).save(str(path))
