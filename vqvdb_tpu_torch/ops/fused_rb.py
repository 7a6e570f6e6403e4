"""The 16-channel residual block of 8^3 leaves as one kernel (counterpart of
`vqvdb_tpu/ops/fused_rb.py`).

    x + res_scale * conv2(relu(gn2(conv1(relu(gn1(x))))))

`residual_block_fused` is the wrapper of `csrc/fused_rb_tc.cu`: on a CUDA
tensor it launches the kernel or raises, on a CPU tensor it returns
`residual_block_plain`, the plain PyTorch version of the same function. The
wrapper counts its kernel launches in `residual_block_fused.launches`.

Arithmetic (every version, as the TPU kernel): x is widened to f32,
GroupNorm statistics, both convs and the residual sum are f32, and the
result is rounded to x's dtype once. For bf16 input the conv weights are
rounded to bf16 first. This differs from `models.blocks.residual_block`,
which rounds to the input dtype between its stages: equal to f32 rounding
for f32 input, within 3e-2 for bf16.

The kernel multiplies on the bf16 tensor cores: each GroupNorm output is
split into three bf16 terms (`ops.quantize.split_bf16`), and each conv is a
sum of bf16 x bf16 products with f32 sums. `residual_block_split_plain`
repeats those products term by term.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from vqvdb_tpu_torch.core.config import LEAF_DIM
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.ops.build import call, on_card, require
from vqvdb_tpu_torch.ops.quantize import PRODUCTS_F32_ROWS, split_bf16

CHANNELS = 16
EPS = 1e-5
# (activation term, weight term) of each product, in the order the kernel
# starts them. Activation terms: 0 hi, 1 mid, 2 lo, 3 hi with its non-finite
# values zeroed. bf16 input has one weight term (the bf16 weights), f32 input
# three, of which the products of order <= 2 are kept.
PRODUCTS_BF16 = ((2, 0), (1, 0), (0, 0))
PRODUCTS_F32 = PRODUCTS_F32_ROWS


def _conv_weight(conv: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The conv's OIDHW weight in f32, rounded through bf16 for bf16 input."""
    w = conv["w"]
    if dtype == torch.bfloat16:
        w = w.to(torch.bfloat16)
    return w.to(torch.float32)


def residual_block_plain(params: Dict, x: torch.Tensor, groups: int = 8,
                         res_scale: float = 0.1) -> torch.Tensor:
    """Plain version of the fused kernel: [B,8,8,8,16] -> the same shape
    and dtype."""
    xf = x.to(torch.float32)
    h = xf
    with blocks.no_tf32(x.device):
        for gn, conv in (("gn1", "conv1"), ("gn2", "conv2")):
            h = torch.relu(blocks.group_norm(params[gn], h, groups, EPS))
            w = _conv_weight(params[conv], x.dtype)
            b = params[conv]["b"].to(torch.float32)
            h = F.conv3d(h.permute(0, 4, 1, 2, 3), w, b, padding=1)
            h = h.permute(0, 2, 3, 4, 1)
    return (xf + res_scale * h).to(x.dtype)


def residual_block_split_plain(params: Dict, x: torch.Tensor, groups: int = 8,
                               res_scale: float = 0.1) -> torch.Tensor:
    """The kernel's arithmetic, term by term in PyTorch: each GroupNorm
    output split into bf16 terms, each conv the sum of its bias and the
    products of `PRODUCTS_BF16` / `PRODUCTS_F32` (exact bf16 x bf16 products,
    f32 sums), small products first. (The kernel adds tap by tap in the
    tensor cores' order, so it agrees to f32 rounding, not bit for bit.)"""
    xf = x.to(torch.float32)
    h = xf
    bf16 = x.dtype == torch.bfloat16
    with blocks.no_tf32(x.device):
        for gn, conv in (("gn1", "conv1"), ("gn2", "conv2")):
            y = torch.relu(blocks.group_norm(params[gn], h, groups, EPS))
            a = [t.to(torch.float32) for t in split_bf16(y.permute(0, 4, 1, 2, 3))]
            a.append(torch.where(torch.isfinite(a[0]), a[0], torch.zeros_like(a[0])))
            w = _conv_weight(params[conv], x.dtype)
            w_terms = [w] if bf16 else [t.to(torch.float32) for t in split_bf16(w)]
            acc = params[conv]["b"].to(torch.float32).reshape(1, -1, 1, 1, 1)
            for at, wt in PRODUCTS_BF16 if bf16 else PRODUCTS_F32:
                acc = acc + F.conv3d(a[at], w_terms[wt], padding=1)
            h = acc.permute(0, 2, 3, 4, 1)
    return (xf + res_scale * h).to(x.dtype)


def residual_block_fused(params: Dict, x: torch.Tensor, *, groups: int = 8,
                         res_scale: float = 0.1) -> torch.Tensor:
    """Drop-in twin of `blocks.residual_block` for 8^3 leaves at C=16.

    x: [B,8,8,8,16] bf16 or f32, dense NDHWC. params: the block's tree in
    the port's layout (OIDHW 3^3 conv weights).
    """
    leaf = (LEAF_DIM, LEAF_DIM, LEAF_DIM, CHANNELS)
    require(x.dim() == 5 and tuple(x.shape[1:]) == leaf,
            f"want x [B,8,8,8,{CHANNELS}], got {tuple(x.shape)}")
    require(x.dtype in (torch.float32, torch.bfloat16),
            f"x must be float32 or bfloat16, got {x.dtype}")
    require(groups >= 1 and CHANNELS % groups == 0,
            f"groups must divide {CHANNELS}, got {groups}")
    convs = [params["conv1"], params["conv2"]]
    for conv in convs:
        require(tuple(conv["w"].shape) == (CHANNELS, CHANNELS, 3, 3, 3),
                f"want 3^3 conv weights [16,16,3,3,3], got {tuple(conv['w'].shape)}")
    small = [params["gn1"]["scale"], params["gn1"]["bias"], convs[0]["b"],
             params["gn2"]["scale"], params["gn2"]["bias"], convs[1]["b"]]
    if not on_card(x, *(c["w"] for c in convs), *small):
        # The plain version's convs sum in an order chosen by shape, as the
        # codec's own convs do: in fixed-shape blocks at inference.
        return blocks.row_wise(lambda t: residual_block_plain(params, t, groups, res_scale), x)
    require(x.is_contiguous(), "x must be a dense NDHWC tensor "
            f"(strides {x.stride()}); the kernel makes no copy")
    require(x.data_ptr() % 16 == 0, "x is not 16-byte aligned")
    # [O,I,kd,kh,kw] -> [conv, 27 taps, I, O] f32, the layout the kernel
    # reads; it rounds the weights to bf16 itself for bf16 x.
    w = torch.stack([c["w"].permute(2, 3, 4, 1, 0) for c in convs]).to(torch.float32)
    prm = torch.stack(small).to(torch.float32)
    out = torch.empty_like(x)
    if x.shape[0]:
        call("vq_residual_block16", x.device, x.data_ptr(),
             int(x.dtype == torch.bfloat16), w[0].data_ptr(), w[1].data_ptr(),
             prm.data_ptr(), out.data_ptr(), x.shape[0], groups,
             float(res_scale), EPS)
        residual_block_fused.launches += 1
    return out


residual_block_fused.launches = 0
