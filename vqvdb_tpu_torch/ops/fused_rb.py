"""The 16-channel residual block of 8^3 leaves as one kernel (counterpart of
`vqvdb_tpu/ops/fused_rb.py`).

    x + res_scale * conv2(relu(gn2(conv1(relu(gn1(x))))))

`residual_block_fused` is the wrapper of `csrc/fused_rb.cu`: on a CUDA
tensor it launches the kernel or raises, on a CPU tensor it returns
`residual_block_plain`, the plain PyTorch version of the same function. The
wrapper counts its kernel launches in `residual_block_fused.launches`.

Arithmetic (both versions, as the TPU kernel): x is widened to f32,
GroupNorm statistics, both convs and the residual sum are f32, and the
result is rounded to x's dtype once. For bf16 input the conv weights are
rounded to bf16 first. This differs from `models.blocks.residual_block`,
which rounds to the input dtype between its stages: equal to f32 rounding
for f32 input, within 3e-2 for bf16.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from vqvdb_tpu_torch.core.config import LEAF_DIM
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.ops.build import call, on_card, require

CHANNELS = 16
EPS = 1e-5


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
        return residual_block_plain(params, x, groups, res_scale)
    require(x.is_contiguous(), "x must be a dense NDHWC tensor "
            f"(strides {x.stride()}); the kernel makes no copy")
    require(x.data_ptr() % 16 == 0, "x is not 16-byte aligned")
    # [O,I,kd,kh,kw] -> [27 taps, I, O], the layout the kernel reads.
    w1, w2 = (_conv_weight(c, x.dtype).permute(2, 3, 4, 1, 0)
              .reshape(27, CHANNELS, CHANNELS).contiguous() for c in convs)
    prm = torch.stack([v.to(torch.float32) for v in small]).contiguous()
    out = torch.empty_like(x)
    if x.shape[0]:
        call("vq_residual_block16", x.device, x.data_ptr(),
             int(x.dtype == torch.bfloat16), w1.data_ptr(), w2.data_ptr(),
             prm.data_ptr(), out.data_ptr(), x.shape[0], groups,
             float(res_scale), EPS)
        residual_block_fused.launches += 1
    return out


residual_block_fused.launches = 0
