"""Decoder-tail collapse: up_conv -> pixel_shuffle -> final conv as one GEMM
(counterpart of `vqvdb_tpu/ops/tail.py`).

The tail has no nonlinearity before the head activation, so the map
(4^3 x 64) -> (8^3 x 1) is one fixed affine operator. It is built exactly
by pushing the output basis back through the tail's own convs (512 VJPs,
not 4096 forwards) and applied as `(B, 4096) @ (4096, 512)`. Rows are in
NDHWC order (d, h, w, c) of the 4^3 x 64 input; the 512 outputs are the
8^3 voxels in (d, h, w) row-major order.

The GEMM is a plain large product, so it stays `torch.matmul`: the
features and the operator are rounded to the compute dtype and then
multiplied in f32, which is the JAX package's bf16 x bf16 -> f32 product.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.func import vjp, vmap

from vqvdb_tpu_torch.core.config import LATENT_VOXELS, LEAF_DIM, ModelConfig
from vqvdb_tpu_torch.models import blocks


def _no_tf32(device: torch.device):
    """cuDNN runs f32 convs in TF32 by default; the fold must be f32."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def fold_decoder_tail(decoder_params: Dict, cfg: ModelConfig
                      ) -> Dict[str, torch.Tensor]:
    """{'k': (4096, 512) f32, 'b': (512,) f32} on the params' device."""
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
    with torch.no_grad(), _no_tf32(device):
        bias, pullback = vjp(tail_flat, zero)
        basis = torch.eye(bias.shape[0], dtype=torch.float32, device=device)
        # rows of J (d_out, d_in) -> K = J^T (d_in, d_out)
        (jac,) = vmap(pullback)(basis)
    return {"k": jac.T.contiguous(), "b": bias.detach()}


def apply_decoder_tail(folded: Dict, h: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    """h (B,4,4,4,64) -> sigmoid activations (B,8,8,8,C) f32."""
    b = h.shape[0]
    k = folded["k"].to(h.dtype).to(torch.float32)
    logits = h.reshape(b, -1).to(torch.float32) @ k + folded["b"]
    logits = logits.reshape(b, LEAF_DIM, LEAF_DIM, LEAF_DIM, cfg.in_channels)
    return torch.sigmoid(logits)
