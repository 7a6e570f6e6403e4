"""Configuration dataclasses (counterpart of `vqvdb_tpu/core/config.py`).

`ModelConfig` keeps the JAX package's fields and validation so a `.vqmodel`
config block loads unchanged. `CodecConfig` keeps the pipeline knobs that
mean something on the card. The JAX package's `use_pallas` and
`use_pallas_dequant` (its kernel switches: on a CUDA tensor the codec
always runs the hand-written kernels), `split_conv_in` and `donate_buffers`
(XLA scheduling and buffer donation) and `param_dtype` (read by no JAX
code path) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Geometry of an OpenVDB FloatGrid leaf node.
LEAF_DIM = 8
# The encoder downsamples 8^3 -> 4^3.
LATENT_DIM = 4
LATENT_VOXELS = LATENT_DIM**3  # 64

ENCODER_ARCHS = ("reference", "packed", "packed_lite", "packed_stem")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VQ-VAE architecture hyperparameters (same fields as the JAX package)."""

    in_channels: int = 1
    embedding_dim: int = 128
    num_embeddings: int = 256
    commitment_cost: float = 0.25
    ema_decay: float = 0.95
    ema_eps: float = 1e-4
    num_quantizers: int = 1
    encoder_arch: str = "reference"

    def __post_init__(self):
        if self.encoder_arch not in ENCODER_ARCHS:
            raise ValueError(
                f"unknown encoder_arch {self.encoder_arch!r} (expected "
                "'reference', 'packed', 'packed_lite', or 'packed_stem')")

    @property
    def variant(self) -> str:
        """'scalar' (sigmoid head) or 'vec3' (tanh head)."""
        return "scalar" if self.in_channels == 1 else "vec3"

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        return (LATENT_DIM, LATENT_DIM, LATENT_DIM)

    @property
    def index_shape(self) -> Tuple[int, ...]:
        """(4,4,4) single-stage, (4,4,4,S) residual-VQ."""
        if self.num_quantizers == 1:
            return self.latent_shape
        return self.latent_shape + (self.num_quantizers,)

    @property
    def index_dtype(self) -> np.dtype:
        # The v3 container stores one byte per latent index.
        return np.dtype(np.uint8 if self.num_embeddings <= 256 else np.uint16)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Runtime codec settings.

    batch_size: leaves per device step; every step runs at exactly this
        size (the ragged tail is zero-padded and cropped on the host).
    compute_dtype: conv/GEMM precision of the model graph.
    fuse_decoder_tail: run up_conv -> pixel shuffle -> final conv as one
        folded GEMM (ops/tail.py).
    fuse_final_conv: with fuse_decoder_tail off, run the final conv folded
        before the shuffle (ops/subpixel.py); both off run the three ops in
        turn.
    fuse_proj_quantize: fold the encoder's 1x1 projection into the
        quantizer score GEMM (score-argmin kernel); off runs the projection
        and then the nearest-code kernel.
    pack_down_conv: run the reference encoder's strided conv as a k3 conv
        on the space-to-channel grid (ops/packed.py). As in the JAX
        package it takes effect only together with the folded projection
        (`fuse_proj_quantize` on a single-stage model) and has no effect
        on the packed encoders.
    fuse_rb16: run the reference scalar encoder's 16-channel residual
        block as one kernel (ops/fused_rb.py) on the `pack_down_conv`
        path. The JAX package defaults this to off; here the card path
        runs the hand-written kernel unless the caller turns it off,
        which selects the eager `blocks.residual_block`.
    """

    batch_size: int = 4096
    compute_dtype: str = "bfloat16"
    fuse_decoder_tail: bool = True
    fuse_final_conv: bool = True
    fuse_proj_quantize: bool = True
    pack_down_conv: bool = True
    fuse_rb16: bool = True

    def __post_init__(self):
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'bfloat16' or 'float32', got "
                f"{self.compute_dtype!r}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)
