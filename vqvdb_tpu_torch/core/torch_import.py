"""Import reference torch checkpoints (counterpart of
`vqvdb_tpu/core/torch_import.py`).

A user of the reference has trained `.pth` checkpoints: torch state_dicts
saved by its trainer, either the full checkpoint dict with a "state_dict"
entry or a bare state_dict. This module maps them, with numpy only, onto the
JAX-layout params tree that `core.artifact.load_model` also returns;
`core.weights.params_from_jax` turns that into the port's tensors.

  torch layout -> JAX layout
    Conv3d.weight  (O, I, kD, kH, kW)  ->  w (kD, kH, kW, I, O)   [DHWIO]
    Conv3d.bias    (O,)                ->  b
    GroupNorm.weight/bias (C,)         ->  scale/bias (C,)
    Linear.weight  (out, in)           ->  w (in, out)
    quantizer buffers (embedding, cluster_size, embed_avg) -> vq

Key names follow the reference module tree: encoder.pre.{0 conv, 1 gn,
3 residual}, encoder.down (encoder.down1 for vec3), encoder.res_stack.N,
encoder.attn.fc.{0,2}, encoder.proj, decoder.stem.{0,1},
decoder.res_stack.N, decoder.attn.fc.{0,2}, decoder.up_conv,
decoder.final, quantizer.*. The tree's keys come in the JAX importer's
order, so a `.vqmodel` written from it is byte-identical to the JAX
package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np

from vqvdb_tpu_torch.core.config import ModelConfig


def _f32(v) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(v, np.float32))


def _conv(sd: Mapping, prefix: str) -> Dict:
    p = {"w": _f32(np.transpose(np.asarray(sd[f"{prefix}.weight"], np.float32),
                                (2, 3, 4, 1, 0)))}
    if f"{prefix}.bias" in sd:
        p["b"] = _f32(sd[f"{prefix}.bias"])
    return p


def _gn(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _f32(sd[f"{prefix}.weight"]), "bias": _f32(sd[f"{prefix}.bias"])}


def _res_block(sd: Mapping, prefix: str) -> Dict:
    return {
        "gn1": _gn(sd, f"{prefix}.gn1"),
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "gn2": _gn(sd, f"{prefix}.gn2"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
    }


def _attn(sd: Mapping, prefix: str) -> Dict:
    w1 = np.asarray(sd[f"{prefix}.fc.0.weight"], np.float32)  # (out, in)
    w2 = np.asarray(sd[f"{prefix}.fc.2.weight"], np.float32)
    return {"fc1": {"w": _f32(w1.T)}, "fc2": {"w": _f32(w2.T)}}


def _encoder(sd: Mapping, cfg: ModelConfig) -> Dict:
    if cfg.variant == "scalar":
        return {
            "pre_conv": _conv(sd, "encoder.pre.0"),
            "pre_gn": _gn(sd, "encoder.pre.1"),
            "pre_rb": _res_block(sd, "encoder.pre.3"),
            "down": _conv(sd, "encoder.down"),
            "rb": _res_block(sd, "encoder.res_stack.0"),
            "attn": _attn(sd, "encoder.attn"),
            "proj": _conv(sd, "encoder.proj"),
        }
    return {
        "pre_conv": _conv(sd, "encoder.pre.0"),
        "pre_gn": _gn(sd, "encoder.pre.1"),
        "pre_rb": _res_block(sd, "encoder.pre.3"),
        "down": _conv(sd, "encoder.down1"),
        "rb1": _res_block(sd, "encoder.res_stack.0"),
        "rb2": _res_block(sd, "encoder.res_stack.1"),
        "attn": _attn(sd, "encoder.attn"),
        "proj": _conv(sd, "encoder.proj"),
    }


def _decoder(sd: Mapping, cfg: ModelConfig) -> Dict:
    out = {
        "stem_conv": _conv(sd, "decoder.stem.0"),
        "stem_gn": _gn(sd, "decoder.stem.1"),
    }
    if cfg.variant == "scalar":
        out["rb"] = _res_block(sd, "decoder.res_stack.0")
    else:
        out["rb1"] = _res_block(sd, "decoder.res_stack.0")
        out["rb2"] = _res_block(sd, "decoder.res_stack.1")
    out["attn"] = _attn(sd, "decoder.attn")
    out["up_conv"] = _conv(sd, "decoder.up_conv")
    out["final"] = _conv(sd, "decoder.final")
    return out


def import_state_dict(sd: Mapping, cfg: ModelConfig) -> Dict:
    """A reference torch state_dict (tensors or numpy arrays) -> the
    JAX-layout params tree {encoder, decoder, vq} of float32 numpy arrays.
    Raises KeyError with the missing key's name on a mismatch."""
    if cfg.encoder_arch != "reference":
        raise ValueError(
            "torch checkpoints carry the reference encoder layout; import "
            "them with encoder_arch='reference' (the packed arch is "
            "TPU-only, trained from scratch)")
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
          for k, v in sd.items()}
    vq = {
        "embedding": _f32(sd["quantizer.embedding"]),
        "cluster_size": _f32(sd["quantizer.cluster_size"]),
        "embed_avg": _f32(sd["quantizer.embed_avg"]),
    }
    if vq["embedding"].shape != (cfg.num_embeddings, cfg.embedding_dim):
        raise ValueError(
            f"checkpoint codebook {vq['embedding'].shape} != config "
            f"({cfg.num_embeddings}, {cfg.embedding_dim})")
    return {"encoder": _encoder(sd, cfg), "decoder": _decoder(sd, cfg), "vq": vq}


def import_torch_checkpoint(path: Union[str, Path], cfg: ModelConfig) -> Dict:
    """Load a reference .pth checkpoint (full train checkpoint or bare
    state_dict) and convert it."""
    import torch

    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return import_state_dict(obj, cfg)
