"""VQ-VAE graphs, inference parts (counterpart of
`vqvdb_tpu/models/vqvae.py`).

Ported so far: the packed scalar encoder (`encoder_arch` "packed" and
"packed_lite", which differ only in the residual block's closer kernel) and
the scalar decoder. The reference and packed_stem encoders, vec3 and
residual-VQ wait for later slices and raise ConfigError here.

  packed enc: s2c(2) (8,8,8,1)->(4,4,4,8) | conv k3 8->64 GN(8) relu
              | RB(64) | CA(64) | proj 1x1 64->D
  scalar dec: conv k3 D->64 GN(8) relu | RB(64) | CA(64)
              | up_conv k3 64->256 | pixel_shuffle(2) | conv k3 32->1 | sigmoid
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.ops.packed import space_to_channel
from vqvdb_tpu_torch.utils.errors import ConfigError

Params = Dict[str, Any]

PORTED_ENCODER_ARCHS = ("packed", "packed_lite")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ConfigError for a model this package cannot run yet."""
    if cfg.encoder_arch not in PORTED_ENCODER_ARCHS:
        raise ConfigError(
            f"encoder_arch {cfg.encoder_arch!r} is not ported yet "
            f"(ported: {', '.join(PORTED_ENCODER_ARCHS)})")
    if cfg.variant != "scalar":
        raise ConfigError("the vec3 variant is not ported yet")
    if cfg.num_quantizers != 1:
        raise ConfigError("residual-VQ models are not ported yet")


def encoder_features(params: Params, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Packed encoder up to (excluding) the 1x1 projection:
    (B,8,8,8,C) -> (B,4,4,4,64)."""
    check_ported(cfg)
    h = space_to_channel(x, 2)
    h = blocks.conv3d(params["stem_conv"], h,
                      padding=blocks.same_padding(params["stem_conv"]))
    h = torch.relu(blocks.group_norm(params["stem_gn"], h, 8))
    h = blocks.residual_block(params["rb"], h)
    return blocks.channel_attention(params["attn"], h)


def encoder_apply(params: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """x (B,8,8,8,C) -> latents (B,4,4,4,D)."""
    return blocks.conv3d(params["proj"], encoder_features(params, x, cfg))


def decoder_pre_tail(params: Params, z: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Decoder up to (excluding) up_conv: (B,4,4,4,D) -> (B,4,4,4,64)."""
    check_ported(cfg)
    h = blocks.conv3d(params["stem_conv"], z, padding=1)
    h = torch.relu(blocks.group_norm(params["stem_gn"], h, 8))
    h = blocks.residual_block(params["rb"], h)
    return blocks.channel_attention(params["attn"], h)


def decoder_tail(params: Params, h: torch.Tensor) -> torch.Tensor:
    """up_conv -> pixel shuffle -> final conv -> sigmoid:
    (B,4,4,4,64) -> (B,8,8,8,1) f32."""
    h = blocks.conv3d(params["up_conv"], h, padding=1)
    h = blocks.pixel_shuffle_3d(h, 2)
    h = blocks.conv3d(params["final"], h, padding=1)
    return torch.sigmoid(h.to(torch.float32))


def decoder_apply(params: Params, z: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """z (B,4,4,4,D) -> reconstruction (B,8,8,8,C) f32."""
    return decoder_tail(params, decoder_pre_tail(params, z, cfg))
