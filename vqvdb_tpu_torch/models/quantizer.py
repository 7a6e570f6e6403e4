"""Vector quantizer, inference parts (counterpart of
`vqvdb_tpu/models/quantizer.py`).

`nearest_indices` and `dequantize` are the plain PyTorch versions of the
nearest-code and dequantize kernels (`ops/quantize.py`). The tests hold
them to the JAX package, and the kernels are held to them on the card.

`rvq_indices` and `rvq_dequantize` are the residual-VQ pair: S codebooks
stacked as [S, K, D], stage s coding what stages < s left over. Their
per-stage steps go through the kernels' wrappers (imported inside the
functions: `ops/quantize.py` imports this module), so on the card each
stage launches the nearest-code and dequantize kernels once and on the CPU
their plain versions run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def nearest_scores(flat_z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, K] partial squared distances ||e||^2 - 2 z.e in f32. The ||z||^2
    term is dropped: it is constant per row and cannot move the argmin."""
    z = flat_z.to(torch.float32)
    e = codebook.to(torch.float32)
    return (e * e).sum(dim=1)[None, :] - 2.0 * (z @ e.T)


def nearest_indices(flat_z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """flat_z [N, D], codebook [K, D] -> int64 [N] nearest code, first
    minimum on ties (NaN rows: the first NaN, like jnp.argmin)."""
    return torch.argmin(nearest_scores(flat_z, codebook), dim=1)


def dequantize(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """indices [N] (any int dtype), codebook [K, D] -> [N, D] rows in the
    codebook's dtype. An index outside [0, K) gives an all-zero row, as the
    JAX package's one-hot product does."""
    k = codebook.shape[0]
    idx = indices.to(torch.int64)
    valid = (idx >= 0) & (idx < k)
    rows = codebook[torch.where(valid, idx, 0)]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def rvq_indices(flat_z: torch.Tensor, codebooks: torch.Tensor,
                prepared: Optional[Sequence] = None) -> torch.Tensor:
    """flat_z [N, D], codebooks [S, K, D] -> int32 [N, S]: per stage the
    nearest code to the f32 residual, whose row is then subtracted.
    `prepared` holds each stage's `ops.quantize.prepare_codebook`, which
    saves splitting the codebooks on every call."""
    from vqvdb_tpu_torch.ops.quantize import fused_dequantize, fused_nearest_indices

    res = flat_z.to(torch.float32)
    idx = []
    for s, codebook in enumerate(codebooks.to(torch.float32)):
        i = fused_nearest_indices(res, prepared[s] if prepared is not None else codebook)
        idx.append(i)
        res = res - fused_dequantize(i, codebook)
    return torch.stack(idx, dim=-1)


def rvq_dequantize(indices: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """indices [N, S], codebooks [S, K, D] -> [N, D]: the stages' rows summed
    in the codebooks' dtype (cast them to the compute dtype first)."""
    from vqvdb_tpu_torch.ops.quantize import fused_dequantize

    out = None
    for s, codebook in enumerate(codebooks):
        q = fused_dequantize(indices[:, s].contiguous(), codebook)
        out = q if out is None else out + q
    return out
