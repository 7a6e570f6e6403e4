"""GroupNorm + affine + ReLU over channels-last leaves as one kernel.

    relu(group_norm(x) * scale + bias)   in x's dtype

`group_norm_relu_fused` is the wrapper of `csrc/group_norm.cu`: on a CUDA
tensor it launches the kernel or raises, on a CPU tensor it returns
`group_norm_relu_plain`, which is `torch.relu(blocks.group_norm(...))`. The
wrapper counts its kernel launches in `group_norm_relu_fused.launches`.

The kernel repeats the eager version's f32 roundings one for one; only its
two sums (the mean and the mean of squared deviations) run in another, fixed
order. `group_norm_plan` picks how the kernel lays a leaf over threads from
the leaf's shape and dtype alone, so a leaf gets the same bits in a batch of
any size.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.ops.build import call, on_card, require

MAX_THREADS = 512  # threads of a block, and so of the team that owns a leaf
VECTOR_BYTES = 16
VECTORS_PER_THREAD = 8  # more where a team of 8 would pass MAX_THREADS
MAX_TILE_BYTES = 192 * 1024  # a block's leaves in shared memory (else read in each pass)
MAX_SMEM_BYTES = 227 * 1024  # shared memory a block may ask for on the H100


class Plan(NamedTuple):
    """How the kernel lays a leaf of S voxels x C channels over threads:
    `ve` values a vector (of one group), `v` vectors a thread, `team`
    threads a leaf, `leaves` leaves a block; `staged` if the block's leaves
    go through shared memory (else each pass reads device memory)."""
    ve: int
    v: int
    team: int
    leaves: int
    staged: bool


def group_norm_plan(s: int, c: int, groups: int, elem_bytes: int) -> Plan:
    """The kernel's plan for leaves of s voxels x c channels in `groups`
    groups of elem_bytes values; raises ValueError for a shape it cannot
    take."""
    require(groups >= 1 and c % groups == 0, f"groups ({groups}) must divide channels ({c})")
    per_group = c // groups
    ve = VECTOR_BYTES // elem_bytes
    while per_group % ve:
        ve //= 2
    nv = s * (c // ve)  # vectors of a leaf
    v = VECTORS_PER_THREAD
    while nv // v > MAX_THREADS:
        v *= 2
    while v > 1 and nv // v < 32:
        v //= 2
    team = nv // v
    require(s % v == 0 and team <= MAX_THREADS,
            f"a leaf of {s} voxels x {c} channels of {elem_bytes} bytes is too large for "
            f"one block of {MAX_THREADS} threads")
    require(s * c * elem_bytes % 16 == 0,
            f"a leaf of {s} voxels x {c} channels of {elem_bytes} bytes is not whole 16-byte "
            "copies")

    def fits(leaves):  # the tile, a partial a thread and a total a (leaf, group)
        tile = leaves * s * c * elem_bytes
        threads = -(-team * leaves // 32) * 32
        return tile <= MAX_TILE_BYTES and tile + 4 * (threads + leaves * groups) <= MAX_SMEM_BYTES

    leaves = max(1, MAX_THREADS // team)
    if not fits(leaves):
        leaves = 1  # one leaf a block, staged if it fits alone
    return Plan(ve, v, team, leaves, fits(leaves))


def group_norm_relu_plain(params: Dict[str, torch.Tensor], x: torch.Tensor, groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the kernel: the eager GroupNorm and ReLU."""
    return torch.relu(blocks.group_norm(params, x, groups, eps))


def group_norm_relu_fused(params: Dict[str, torch.Tensor], x: torch.Tensor, groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """relu(GroupNorm(x)) for x [B, *spatial, C], bf16 or f32, dense
    channels-last; params {"scale", "bias"} of C values. The checks are the
    kernel's on either device."""
    scale, bias = params["scale"], params["bias"]
    require(x.dtype in (torch.float32, torch.bfloat16),
            f"x must be float32 or bfloat16, got {x.dtype}")
    require(x.dim() >= 3, f"want x [B, *spatial, C], got {tuple(x.shape)}")
    require(x.is_contiguous(), "x must be a dense channels-last tensor "
            f"(strides {x.stride()}); the kernel makes no copy")
    b, c = x.shape[0], x.shape[-1]
    s = math.prod(x.shape[1:-1])
    plan = group_norm_plan(s, c, groups, x.element_size())
    require(scale.numel() == c and bias.numel() == c,
            f"scale and bias must hold {c} values, got {scale.numel()} and {bias.numel()}")
    if not on_card(x, scale, bias):
        return group_norm_relu_plain(params, x, groups, eps)
    require(x.data_ptr() % VECTOR_BYTES == 0, "x is not 16-byte aligned")
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if b:
        call("vq_group_norm_relu", x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
             scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, c, groups,
             plan.ve, plan.v, plan.leaves, int(plan.staged), float(eps))
        group_norm_relu_fused.launches += 1
    return out


group_norm_relu_fused.launches = 0
