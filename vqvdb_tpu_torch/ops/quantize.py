"""The quantizer's kernels: wrappers, plain versions and the projection fold
(counterpart of `vqvdb_tpu/ops/quantize.py`).

Three wrappers, one per TPU kernel of the JAX package:

  fused_dequantize       csrc/dequantize.cu    indices -> codebook rows
  fused_score_argmin     csrc/score_argmin.cu  argmin_k(h @ M + c)
  fused_nearest_indices  csrc/score_argmin.cu  argmin_k(||e||^2 - 2 z.e)

On a CPU tensor a wrapper returns its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts its kernel
launches in a plain int attribute, `<wrapper>.launches`, bumped once per
launch and nowhere else. Results are int32 indices / rows in the codebook
dtype on both paths.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vqvdb_tpu_torch.models.quantizer import dequantize, nearest_indices
from vqvdb_tpu_torch.ops.build import call, on_card, require


# ---------------------------------------------------------------------------
# Dequantize
# ---------------------------------------------------------------------------

def fused_dequantize(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """indices [N] (uint8 or int32 on the card; any int on the CPU),
    codebook [K, D] -> rows [N, D] in the codebook's dtype; an index outside
    [0, K) gives an all-zero row."""
    require(indices.dim() == 1 and codebook.dim() == 2,
             f"want indices [N] and codebook [K, D], got "
             f"{tuple(indices.shape)} and {tuple(codebook.shape)}")
    if not on_card(indices, codebook):
        return dequantize(indices, codebook)
    require(indices.dtype in (torch.uint8, torch.int32),
             f"indices must be uint8 or int32 on the card, got {indices.dtype}")
    require(codebook.dtype in (torch.float32, torch.bfloat16),
             f"codebook must be float32 or bfloat16, got {codebook.dtype}")
    k, d = codebook.shape
    row_bytes = d * codebook.element_size()
    require(row_bytes % 16 == 0, f"codebook rows of {row_bytes} B are not "
             "a multiple of 16 B")
    indices = indices.contiguous()
    codebook = codebook.contiguous()
    require(codebook.data_ptr() % 16 == 0, "codebook is not 16-byte aligned")
    n = indices.shape[0]
    out = torch.empty((n, d), dtype=codebook.dtype, device=codebook.device)
    if n:
        call("vq_dequantize", codebook.device, indices.data_ptr(),
              indices.element_size(), codebook.data_ptr(), out.data_ptr(),
              n, k, row_bytes)
        fused_dequantize.launches += 1
    return out


fused_dequantize.launches = 0


# ---------------------------------------------------------------------------
# Fused projection + nearest-code scoring
# ---------------------------------------------------------------------------
#
# The encoder ends with a 1x1 projection z = h @ P + b followed by
# argmin_k(||e_k||^2 - 2 z.e_k). Both are linear in h, so at inference they
# compose into one score GEMM:
#
#     idx = argmin(h @ M + c),   M = -2 P E^T   (F, K),
#                                 c = ||e||^2 - 2 b E^T   (K,)

def fold_proj_into_scores(proj_w, proj_b, codebook
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX-layout proj_w (1,1,1,F,D) or (F,D), proj_b (D,), codebook (K,D)
    -> (M (F,K) f32, c (1,K) f32) on the CPU, computed in f64."""
    e = np.asarray(codebook, np.float64)
    w = np.asarray(proj_w, np.float64).reshape(-1, e.shape[1])
    b = np.asarray(proj_b, np.float64)
    m = -2.0 * (w @ e.T)
    c = np.sum(e * e, axis=1) - 2.0 * (b @ e.T)
    return (torch.from_numpy(m.astype(np.float32)),
            torch.from_numpy(c[None, :].astype(np.float32)))


def score_argmin_plain(h_flat: torch.Tensor, m: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Plain version of the score-argmin kernel: int32 [N]."""
    scores = h_flat.to(torch.float32) @ m.to(torch.float32) + c.reshape(1, -1)
    return torch.argmin(scores, dim=1).to(torch.int32)


def _check_scores(x: torch.Tensor, m: torch.Tensor, c: torch.Tensor) -> None:
    require(x.dim() == 2 and m.dim() == 2 and m.shape[0] == x.shape[1],
             f"want rows [N, F] and M [F, K], got {tuple(x.shape)} and "
             f"{tuple(m.shape)}")
    k = m.shape[1]
    require(c.numel() == k, f"c has {c.numel()} entries, M has {k} columns")
    require(k % 64 == 0 and 64 <= k <= 256,
             f"the kernel takes K in 64, 128, 192, 256; got {k}")
    require(m.dtype == torch.float32 and c.dtype == torch.float32,
             "M and c must be float32")


def fused_score_argmin(h_flat: torch.Tensor, m: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """h_flat [N, F] (bf16 or f32), M [F, K] f32, c [1, K] f32 -> int32 [N]."""
    if not on_card(h_flat, m, c):
        return score_argmin_plain(h_flat, m, c)
    _check_scores(h_flat, m, c)
    require(h_flat.dtype in (torch.float32, torch.bfloat16),
             f"h must be float32 or bfloat16, got {h_flat.dtype}")
    h_flat, m, c = h_flat.contiguous(), m.contiguous(), c.contiguous()
    n, f = h_flat.shape
    out = torch.empty(n, dtype=torch.int32, device=h_flat.device)
    if n:
        call("vq_score_argmin", h_flat.device, h_flat.data_ptr(),
              int(h_flat.dtype == torch.bfloat16), m.data_ptr(), c.data_ptr(),
              out.data_ptr(), n, f, m.shape[1])
        fused_score_argmin.launches += 1
    return out


fused_score_argmin.launches = 0


# ---------------------------------------------------------------------------
# Nearest-code search
# ---------------------------------------------------------------------------

def fused_nearest_indices(flat_z: torch.Tensor, codebook: torch.Tensor
                          ) -> torch.Tensor:
    """flat_z [N, D] f32, codebook [K, D] -> int32 [N]: argmin_k of
    ||e_k||^2 - 2 z.e_k, first minimum on ties."""
    if not on_card(flat_z, codebook):
        return nearest_indices(flat_z, codebook).to(torch.int32)
    require(flat_z.dtype == torch.float32,
             f"z must be float32 on the card, got {flat_z.dtype}")
    e = codebook.to(torch.float32)
    mt = (-2.0 * e).T.contiguous()  # [D, K]
    esq = (e * e).sum(dim=1)
    _check_scores(flat_z, mt, esq)
    flat_z = flat_z.contiguous()
    n, d = flat_z.shape
    out = torch.empty(n, dtype=torch.int32, device=flat_z.device)
    if n:
        call("vq_nearest_indices", flat_z.device, flat_z.data_ptr(),
              mt.data_ptr(), esq.data_ptr(), out.data_ptr(), n, d,
              mt.shape[1])
        fused_nearest_indices.launches += 1
    return out


fused_nearest_indices.launches = 0
