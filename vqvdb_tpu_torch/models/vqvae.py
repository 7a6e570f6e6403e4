"""VQ-VAE graphs, inference parts (counterpart of
`vqvdb_tpu/models/vqvae.py`).

Ported: the packed encoders (`encoder_arch` "packed" and "packed_lite",
which differ only in the residual block's closer kernel; scalar and vec3
inputs), the reference encoders (scalar and vec3, with the strided conv as
it is or folded onto the packed grid), and both decoders. The packed_stem
encoder is not ported and raises ConfigError; no committed artifact uses it.

  packed enc:   s2c(2) (8,8,8,C)->(4,4,4,8C) | conv k3 8C->W GN(8) relu
                | RB(W) | CA(W) | proj 1x1 W->D        (W = 64 scalar, 128 vec3)
  reference enc, scalar:
                conv k3 1->16 GN(4) relu | RB(16) | conv k4 s2 16->32
                | RB(32) | CA(32) | proj 1x1 32->D
  reference enc, vec3:
                conv k3 3->32 GN(8) relu | RB(32) | conv k3 s2 32->128
                | RB(128) | RB(128) | CA(128) | proj 1x1 128->D
  scalar dec:   conv k3 D->64 GN(8) relu | RB(64) | CA(64)
                | up_conv k3 64->256 | pixel_shuffle(2) | conv k3 32->1 | sigmoid
  vec3 dec:     conv k3 D->128 GN(8) relu | RB(128) | RB(128) | CA(128)
                | up_conv k3 128->256 | pixel_shuffle(2) | conv k3 32->3 | tanh
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused
from vqvdb_tpu_torch.ops.packed import space_to_channel
from vqvdb_tpu_torch.utils.errors import ConfigError

Params = Dict[str, Any]

PORTED_ENCODER_ARCHS = ("reference", "packed", "packed_lite")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ConfigError for a model this package cannot run yet."""
    if cfg.encoder_arch not in PORTED_ENCODER_ARCHS:
        raise ConfigError(
            f"encoder_arch {cfg.encoder_arch!r} is not ported yet "
            f"(ported: {', '.join(PORTED_ENCODER_ARCHS)})")


def _encoder_features_packed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Packed-encoder features: (B,8,8,8,C) -> (B,4,4,4,W)."""
    h = space_to_channel(x, 2)
    h = blocks.conv3d(params["stem_conv"], h,
                      padding=blocks.same_padding(params["stem_conv"]))
    h = torch.relu(blocks.group_norm(params["stem_gn"], h, 8))
    h = blocks.residual_block(params["rb"], h)
    return blocks.channel_attention(params["attn"], h)


def _reference_pre(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   fuse_rb16: bool = False) -> torch.Tensor:
    """The reference encoders' stage on the 8^3 grid: conv, GroupNorm (4
    groups scalar, 8 vec3), relu, residual block."""
    h = blocks.conv3d(params["pre_conv"], x, padding=1)
    pre_groups = 4 if cfg.variant == "scalar" else 8
    h = torch.relu(blocks.group_norm(params["pre_gn"], h, pre_groups))
    if fuse_rb16:
        # The kernel reads a dense NDHWC buffer; a no-op when GroupNorm
        # already handed one over.
        return residual_block_fused(params["pre_rb"], h.contiguous())
    return blocks.residual_block(params["pre_rb"], h)


def _reference_post(params: Params, h: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The reference encoders' stage on the 4^3 grid, after the down conv."""
    if cfg.variant == "scalar":
        h = blocks.residual_block(params["rb"], h)
    else:
        h = blocks.residual_block(params["rb1"], h)
        h = blocks.residual_block(params["rb2"], h)
    return blocks.channel_attention(params["attn"], h)


def encoder_features(params: Params, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Encoder up to (excluding) the 1x1 projection:
    (B,8,8,8,C) -> (B,4,4,4,32|64|128)."""
    check_ported(cfg)
    if cfg.encoder_arch.startswith("packed"):
        return _encoder_features_packed(params, x)
    h = _reference_pre(params, x, cfg)
    # k4 s2 (scalar) / k3 s2 (vec3): 8^3 -> 4^3
    h = blocks.conv3d(params["down"], h, stride=2, padding=1)
    return _reference_post(params, h, cfg)


def encoder_apply(params: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """x (B,8,8,8,C) -> latents (B,4,4,4,D)."""
    return blocks.conv3d(params["proj"], encoder_features(params, x, cfg))


def encoder_features_packed_down(params: Params, folded_down: Params,
                                 x: torch.Tensor, cfg: ModelConfig,
                                 fuse_rb16: bool = False) -> torch.Tensor:
    """Reference encoder only: `encoder_features` with the strided conv run
    as a k3 SAME conv on the space-to-channel grid (`folded_down` from
    ops/packed.py::fold_strided_conv; an exact rewrite). `fuse_rb16` runs
    the scalar variant's 16-channel residual block as one kernel
    (ops/fused_rb.py)."""
    check_ported(cfg)
    h = _reference_pre(params, x, cfg,
                       fuse_rb16=fuse_rb16 and cfg.variant == "scalar")
    h = blocks.conv3d(folded_down, space_to_channel(h, 2), padding=1)
    return _reference_post(params, h, cfg)


def decoder_pre_tail(params: Params, z: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Decoder up to (excluding) up_conv: (B,4,4,4,D) -> (B,4,4,4,64|128)."""
    h = blocks.conv3d(params["stem_conv"], z, padding=1)
    h = torch.relu(blocks.group_norm(params["stem_gn"], h, 8))
    if cfg.variant == "scalar":
        h = blocks.residual_block(params["rb"], h)
    else:
        h = blocks.residual_block(params["rb1"], h)
        h = blocks.residual_block(params["rb2"], h)
    return blocks.channel_attention(params["attn"], h)


def head_activation(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """sigmoid (scalar) or tanh (vec3) of the f32 logits."""
    h = h.to(torch.float32)
    return torch.sigmoid(h) if cfg.variant == "scalar" else torch.tanh(h)


def decoder_tail(params: Params, h: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """up_conv -> pixel shuffle -> final conv -> head activation:
    (B,4,4,4,64|128) -> (B,8,8,8,C) f32."""
    h = blocks.conv3d(params["up_conv"], h, padding=1)
    h = blocks.pixel_shuffle_3d(h, 2)
    h = blocks.conv3d(params["final"], h, padding=1)
    return head_activation(h, cfg)


def decoder_apply(params: Params, z: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """z (B,4,4,4,D) -> reconstruction (B,8,8,8,C) f32."""
    return decoder_tail(params, decoder_pre_tail(params, z, cfg), cfg)
