"""Neural building blocks on channels-last (NDHWC) tensors (counterpart of
`vqvdb_tpu/models/blocks.py`).

Tensors stay NDHWC between blocks, as in the JAX package, so each function
reads like its counterpart. `conv3d` hands cuDNN an NCDHW view of the same
memory (channels-last strides) and weights in OIDHW, also channels-last.

The rounding places follow the JAX functions: GroupNorm and channel
attention compute in f32 and cast back to the input dtype; the residual
scale is rounded to the input dtype before it multiplies.

The initialisers draw the JAX package's distributions (torch's Conv/Linear
defaults: kaiming-uniform with a = sqrt(5) and a uniform bias; N(0, 1e-3)
closer convs; ICNR for the pre-shuffle conv) from a `torch.Generator`, on
its device. JAX's random streams cannot be reproduced, so the values differ
from the JAX package's for any seed; shapes, dtypes and bounds agree.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=gen.device).uniform_(
        -bound, bound, generator=gen)


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=gen.device).normal_(
        0.0, std, generator=gen)


def _kaiming_uniform(gen: torch.Generator, shape, fan_in: int, a: float = math.sqrt(5.0),
                     dtype=torch.float32) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_(a=sqrt(5)): torch's Conv/Linear default."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return _uniform(gen, shape, gain * math.sqrt(3.0 / fan_in), dtype)


def _bias_uniform(gen: torch.Generator, shape, fan_in: int,
                  dtype=torch.float32) -> torch.Tensor:
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in), dtype)


def _conv_weight(w: torch.Tensor) -> torch.Tensor:
    """OIDHW, stored channels-last as `core.weights` stores a loaded conv."""
    return w.contiguous(memory_format=torch.channels_last_3d)


def init_conv3d(gen: torch.Generator, in_ch: int, out_ch: int, kernel: int, *,
                bias: bool = True, dtype=torch.float32) -> Params:
    fan_in = in_ch * kernel**3
    p = {"w": _conv_weight(_kaiming_uniform(
        gen, (out_ch, in_ch, kernel, kernel, kernel), fan_in, dtype=dtype))}
    if bias:
        p["b"] = _bias_uniform(gen, (out_ch,), fan_in, dtype=dtype)
    return p


def init_conv3d_near_zero(gen: torch.Generator, in_ch: int, out_ch: int, kernel: int,
                          std: float = 1e-3, dtype=torch.float32) -> Params:
    """Residual-branch closer conv: N(0, std) weights, zero bias."""
    w = _normal(gen, (out_ch, in_ch, kernel, kernel, kernel), std, dtype)
    return {"w": _conv_weight(w),
            "b": torch.zeros((out_ch,), dtype=dtype, device=gen.device)}


def init_conv3d_icnr(gen: torch.Generator, in_ch: int, out_ch: int, kernel: int,
                     upscale: int = 2, dtype=torch.float32) -> Params:
    """ICNR for the pre-pixel-shuffle conv: out_ch / r^3 kaiming-normal
    (fan_in) filters, each repeated r^3 times in a row along the output
    channels, so the shuffled output starts as nearest-neighbour upsampling."""
    r3 = upscale**3
    sub = out_ch // r3
    if sub == 0:
        raise ValueError("ICNR: out_channels too small.")
    fan_in = in_ch * kernel**3
    temp = _normal(gen, (sub, in_ch, kernel, kernel, kernel),
                   math.sqrt(2.0 / fan_in), dtype)
    return {"w": _conv_weight(temp.repeat_interleave(r3, dim=0)),
            "b": _bias_uniform(gen, (out_ch,), fan_in, dtype=dtype)}


def init_group_norm(num_ch: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((num_ch,), dtype=dtype, device=device),
            "bias": torch.zeros((num_ch,), dtype=dtype, device=device)}


def init_linear(gen: torch.Generator, in_f: int, out_f: int, *, bias: bool = True,
                dtype=torch.float32) -> Params:
    """A linear layer, weight (in, out) as in the JAX package."""
    p = {"w": _kaiming_uniform(gen, (in_f, out_f), in_f, dtype=dtype)}
    if bias:
        p["b"] = _bias_uniform(gen, (out_f,), in_f, dtype=dtype)
    return p


def init_residual_block(gen: torch.Generator, channels: int, dtype=torch.float32,
                        kernel2: int = 3) -> Params:
    return {
        "gn1": init_group_norm(channels, dtype, gen.device),
        "conv1": init_conv3d(gen, channels, channels, 3, dtype=dtype),
        "gn2": init_group_norm(channels, dtype, gen.device),
        "conv2": init_conv3d_near_zero(gen, channels, channels, kernel2, dtype=dtype),
    }


def init_channel_attention(gen: torch.Generator, channels: int, reduction: int = 4,
                           dtype=torch.float32) -> Params:
    return {
        "fc1": init_linear(gen, channels, channels // reduction, bias=False, dtype=dtype),
        "fc2": init_linear(gen, channels // reduction, channels, bias=False, dtype=dtype),
    }


# ---------------------------------------------------------------------------
# Forward ops
# ---------------------------------------------------------------------------


# Rows of each fixed-shape block, by device type: on the card the size
# measured to cost least (`tools/batch_invariance.py`); on the CPU, which
# runs the tests' small batches, a size that pads a small shard cheaply.
ROW_BLOCK = {"cuda": 1024, "cpu": 16}


def in_row_blocks(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for a row-wise fn, computed on blocks of exactly ROW_BLOCK (of
    x's device) rows of x: the last block is padded with zero rows, whose
    outputs are dropped. Every call then has one shape whatever x's row
    count."""
    rows = ROW_BLOCK[x.device.type]
    n = x.shape[0]
    if n == rows:
        return fn(x)
    outs = []
    for i in range(0, n, rows):
        block = x[i:i + rows]
        m = block.shape[0]
        if m < rows:
            block = torch.cat([block, block.new_zeros((rows - m,) + block.shape[1:])])
        outs.append(fn(block)[:m])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def row_wise(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for a row-wise fn that cuBLAS, cuDNN or the CPU's libraries
    compute in an order chosen by the call's shape: at inference (the
    codec's steps run in `torch.inference_mode`) in fixed-shape blocks
    (`in_row_blocks`), so a row gets the same bits in a batch of any size
    and a mesh, whose devices run shards of each batch, writes one
    device's files; in training, where a rank runs one batch shape, in one
    call. On the card a row's bits from one call moved with the rows beside
    it (convs and products at 4096, 2048, 1024 and 512 rows); on the CPU a
    product of 2-16 rows sums in another order than one of 32 or more."""
    return in_row_blocks(fn, x) if torch.is_inference_mode_enabled() else fn(x)


def conv3d(params: Params, x: torch.Tensor, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """3D convolution: NDHWC x OIDHW -> NDHWC (`row_wise`)."""
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype) if "b" in params else None

    def conv(t):
        y = F.conv3d(t.permute(0, 4, 1, 2, 3), w, b, stride=stride, padding=padding)
        return y.permute(0, 2, 3, 4, 1)

    return row_wise(conv, x)


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


def row_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, K) @ b (K, M) (`row_wise`)."""
    return row_wise(lambda t: t @ b, a)


def channel_attention(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excite channel gating; bias-free fc1/fc2, mean in f32."""
    y = x.to(torch.float32).mean(dim=(1, 2, 3))  # (B, C)
    y = torch.relu(row_blocks(y, params["fc1"]["w"].to(torch.float32)))
    y = torch.sigmoid(row_blocks(y, params["fc2"]["w"].to(torch.float32)))
    return x * y[:, None, None, None, :].to(x.dtype)
