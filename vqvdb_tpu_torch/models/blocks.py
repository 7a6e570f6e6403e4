"""Neural building blocks on channels-last (NDHWC) tensors (counterpart of
`vqvdb_tpu/models/blocks.py`).

Tensors stay NDHWC between blocks, as in the JAX package, so each function
reads like its counterpart. `conv3d` hands cuDNN an NCDHW view of the same
memory (channels-last strides) and weights in OIDHW, also channels-last.

The rounding places follow the JAX functions: GroupNorm and channel
attention compute in f32 and cast back to the input dtype; the residual
scale is rounded to the input dtype before it multiplies.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def conv3d(params: Params, x: torch.Tensor, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """3D convolution: NDHWC x OIDHW -> NDHWC."""
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype) if "b" in params else None
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1)


def no_tf32(device: torch.device):
    """Context in which cuDNN runs f32 convs in f32 (it takes TF32 by
    default); for weight folds and plain versions that must be f32."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def same_padding(params: Params) -> int:
    """SAME padding of a stride-1 conv, from its (cubic) kernel size."""
    return (params["w"].shape[-1] - 1) // 2


def group_norm(params: Params, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-last input; statistics in f32."""
    b, d, h, w, c = x.shape
    xf = x.to(torch.float32).reshape(b, d, h, w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 2, 3, 5), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3, 5), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, d, h, w, c)
    y = xf * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return y.to(x.dtype)


def pixel_shuffle_3d(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Voxel shuffle (B,D,H,W,C) -> (B,D*r,H*r,W*r,C/r^3); the channel dim
    splits as (oc, rd, rh, rw) with oc outermost."""
    b, d, h, w, c = x.shape
    r3 = r * r * r
    if c % r3 != 0:
        raise ValueError("Channels not divisible by r^3.")
    oc = c // r3
    x = x.reshape(b, d, h, w, oc, r, r, r)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)  # (b, d, rd, h, rh, w, rw, oc)
    return x.reshape(b, d * r, h * r, w * r, oc)


def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float (multiplying by it
    rounds like the JAX package's `jnp.asarray(value, dtype) * h`)."""
    return float(torch.tensor(value, dtype=dtype))


def residual_block(params: Params, x: torch.Tensor, *, groups: int = 8,
                   scale: float = 0.1) -> torch.Tensor:
    """Pre-activation GN residual block: x + scale * conv2(relu(gn2(
    conv1(relu(gn1 x))))). SAME padding comes from each conv's kernel."""
    h = torch.relu(group_norm(params["gn1"], x, groups))
    h = conv3d(params["conv1"], h, padding=same_padding(params["conv1"]))
    h = torch.relu(group_norm(params["gn2"], h, groups))
    h = conv3d(params["conv2"], h, padding=same_padding(params["conv2"]))
    return x + h * _rounded(scale, x.dtype)


def channel_attention(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excite channel gating; bias-free fc1/fc2, mean in f32."""
    y = x.to(torch.float32).mean(dim=(1, 2, 3))  # (B, C)
    y = torch.relu(y @ params["fc1"]["w"].to(torch.float32))
    y = torch.sigmoid(y @ params["fc2"]["w"].to(torch.float32))
    return x * y[:, None, None, None, :].to(x.dtype)
