"""Decoder-tail collapse: up_conv -> pixel_shuffle -> final conv as one GEMM
(counterpart of `vqvdb_tpu/ops/tail.py`).

The tail has no nonlinearity before the head activation, so the map
(4^3 x C_in) -> (8^3 x C_out) is one fixed affine operator. It is built
exactly by pushing the output basis back through the tail's own convs (one
VJP per output, not one forward per input) and applied as one GEMM:

    scalar: (B, 4096) @ (4096, 512)
    vec3:   (B, 8192) @ (8192, 1536)

Rows are in NDHWC order (d, h, w, c) of the 4^3 x C_in input; the outputs
are the 8^3 x C_out voxels in the same order.

The GEMM is a plain large product, so it stays `torch.matmul`: the
features and the operator are rounded to the compute dtype and then
multiplied in f32, which is the JAX package's bf16 x bf16 -> f32 product.
At inference it runs on fixed-shape blocks of rows (`blocks.row_blocks`),
so that a row's leaves do not depend on how many rows share its batch (a
mesh's devices decode shards of it).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.func import vjp, vmap

from vqvdb_tpu_torch.core.config import LATENT_VOXELS, LEAF_DIM, ModelConfig
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.models.vqvae import head_activation


def fold_decoder_tail(decoder_params: Dict, cfg: ModelConfig
                      ) -> Dict[str, torch.Tensor]:
    """{'k': (64*C_in, 512*C_out) f32, 'b': (512*C_out,) f32} on the params'
    device."""
    up = {k: v.to(torch.float32) for k, v in decoder_params["up_conv"].items()}
    fin = {k: v.to(torch.float32) for k, v in decoder_params["final"].items()}
    c_in = up["w"].shape[1]
    device = up["w"].device

    def tail_flat(h_flat):
        h = h_flat.reshape(1, 4, 4, 4, c_in)
        y = blocks.conv3d(up, h, padding=1)
        y = blocks.pixel_shuffle_3d(y, 2)
        return blocks.conv3d(fin, y, padding=1).reshape(-1)

    zero = torch.zeros(LATENT_VOXELS * c_in, dtype=torch.float32, device=device)
    with torch.no_grad(), blocks.no_tf32(device):
        bias, pullback = vjp(tail_flat, zero)
        basis = torch.eye(bias.shape[0], dtype=torch.float32, device=device)
        # rows of J (d_out, d_in) -> K = J^T (d_in, d_out)
        (jac,) = vmap(pullback)(basis)
    return {"k": jac.T.contiguous(), "b": bias.detach()}


def apply_decoder_tail(folded: Dict, h: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    """h (B,4,4,4,C_in) -> head activations (B,8,8,8,C_out) f32."""
    b = h.shape[0]
    k = folded["k"].to(h.dtype).to(torch.float32)
    logits = blocks.row_blocks(h.reshape(b, -1).to(torch.float32), k) + folded["b"]
    logits = logits.reshape(b, LEAF_DIM, LEAF_DIM, LEAF_DIM, cfg.in_channels)
    return head_activation(logits, cfg)
