"""The quantizer's kernels: wrappers, plain versions and the projection fold
(counterpart of `vqvdb_tpu/ops/quantize.py`).

Three wrappers, one per TPU kernel of the JAX package:

  fused_dequantize       csrc/dequantize.cu    indices -> codebook rows
  fused_score_argmin     csrc/score_argmin_tc.cu  argmin_k(h @ M + c)
  fused_nearest_indices  csrc/score_argmin_tc.cu  argmin_k(||e||^2 - 2 z.e)

The last two share one tensor-core kernel that takes M split into bf16
terms (`prepare_scores`, `prepare_codebook`: made once per model by the
codec, or on the fly when a wrapper is handed raw tensors). They take any
codebook size K from 1 to 65,536 (u16 indices): the kernel runs tiles of at
most 256 codes, one launch per tile (`code_tiles`).

On a CPU tensor a wrapper returns its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts its kernel
launches in a plain int attribute, `<wrapper>.launches`, bumped once per
launch (per code tile for the score kernel) and nowhere else. Results are
int32 indices / rows in the codebook dtype on both paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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
    [0, K) gives an all-zero row. Rows of any width: the kernel moves 16, 8,
    4 or 2 bytes a thread, the widest that divides a row."""
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
    indices = indices.contiguous()
    codebook = codebook.contiguous()
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


# ---------------------------------------------------------------------------
# Split-bf16 products: the kernel's arithmetic, and its prepared B operand
# ---------------------------------------------------------------------------
#
# The kernel multiplies on the bf16 tensor cores. An f32 value is the exact
# sum of three bf16 terms hi + mid + lo; M is split once per model, an f32 row
# in the kernel's registers. A bf16 row takes 3 products per score, an f32 row
# the 6 products of order <= 2, the small ones first in every depth chunk.

CHUNK = 32  # depth of one chunk of the B operand: two k16 MMA steps
# (row term, M term) of each product, in the order they start; terms are 0 hi, 1 mid,
# 2 lo, and row term 3 is hi with its non-finite values zeroed.
PRODUCTS_BF16_ROWS = ((3, 2), (3, 1), (0, 0))
PRODUCTS_F32_ROWS = ((2, 0), (1, 1), (3, 2), (1, 0), (3, 1), (0, 0))


def split_bf16(x: torch.Tensor, terms: int = 3) -> Tuple[torch.Tensor, ...]:
    """x f32 -> `terms` bf16 tensors whose f32 sum rebuilds x (bit for bit
    with three terms, barring underflow of the last). Where the first term is
    not finite (x is NaN or +-inf, or rounds up to inf) the others are zero."""
    x = x.to(torch.float32)
    out = []
    rest = x
    for i in range(terms):
        term = rest.to(torch.bfloat16)
        out.append(term)
        rest = rest - term.to(torch.float32)
        if i == 0:
            rest = torch.where(torch.isfinite(term), rest, torch.zeros_like(rest))
    return tuple(out)


def _pad_depth(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-pad dimension `dim` (0 or 1 of a matrix) to a multiple of CHUNK."""
    pad = -x.shape[dim] % CHUNK
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, pad) if dim == 1 else (0, 0, 0, pad))


MAX_CODES = 65536  # the range of u16 indices
MAX_TILE = 256  # codes of one kernel launch: 128 accumulator registers a thread


def code_tiles(k: int) -> Tuple[int, int]:
    """K codes -> (tile width kt, number of tiles): the fewest tiles of at
    most 256 codes, all of one width, a multiple of 64 (the MMA's N step)."""
    blocks = -(-k // 64)
    tiles = -(-blocks // (MAX_TILE // 64))
    return 64 * -(-blocks // tiles), tiles


@dataclasses.dataclass(frozen=True)
class PreparedScores:
    """M [F, K] and c [K] in f32 with the kernel's operands: c zero-padded
    to tiles x kt codes (`c_tiles`), and the three bf16 terms of M, codes
    zero-padded likewise and depth to a multiple of 32, in the byte order of
    the kernel's shared memory, [tiles, F/32 chunks, 3 terms, 2 steps, kt/8
    code groups, 2 depth halves, 8 codes, 8 depths]: per code tile, 8 x 8
    core matrices of 128 contiguous bytes, K-major. A thread of the kernel
    reads depths 32 d + 8 t .. + 7 of its row (t its lane in the quad) and
    uses values 4u .. 4u + 3 in step u, the first pair as MMA depths 2t,
    2t + 1 and the second as 2t + 8, 2t + 9, so MMA depth 8 half + 2 t + i of
    step u of chunk d is true depth 32 d + 8 t + 4 u + 2 half + i.
    `codebook` is set when M = -2 E^T, c = ||e||^2 were made from one."""
    m: torch.Tensor
    c: torch.Tensor
    operand: torch.Tensor
    c_tiles: torch.Tensor
    codebook: Optional[torch.Tensor] = None

    @property
    def tile(self) -> int:
        return self.operand.shape[4] * 8

    @property
    def tiles(self) -> int:
        return self.operand.shape[0]


def prepare_scores(m: torch.Tensor, c: torch.Tensor,
                   codebook: Optional[torch.Tensor] = None) -> PreparedScores:
    """M [F, K] f32, c [K] or [1, K] f32 -> PreparedScores on M's device."""
    _check_scores(m, c)
    k = m.shape[1]
    kt, tiles = code_tiles(k)
    pad = tiles * kt - k
    mp = torch.nn.functional.pad(m, (0, pad))
    terms = torch.stack(split_bf16(_pad_depth(mp, 0)))  # [3, Fp, tiles * kt]
    # depth -> (chunk d, lane t, step u, half, i); codes -> (tile, group, code)
    t = terms.reshape(3, -1, 4, 2, 2, 2, tiles, kt // 8, 8)
    # -> [tile, d, term, u, group, half, code, t, i]; (t, i) merge into 2 t + i
    operand = t.permute(6, 1, 0, 3, 7, 4, 8, 2, 5).reshape(
        tiles, -1, 3, 2, kt // 8, 2, 8, 8)
    c = c.reshape(-1).contiguous()
    return PreparedScores(m.contiguous(), c, operand.contiguous(),
                          torch.nn.functional.pad(c, (0, pad)), codebook)


def prepare_codebook(codebook: torch.Tensor) -> PreparedScores:
    """codebook [K, D] -> the nearest-code search as scores:
    M = -2 E^T [D, K], c = ||e||^2."""
    e = codebook.to(torch.float32)
    return prepare_scores((-2.0 * e).T.contiguous(), (e * e).sum(dim=1), e)


def score_argmin_split_plain(h_flat: torch.Tensor, m: torch.Tensor,
                             c: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic, term by term in PyTorch: bf16 terms, exact
    products, f32 sums chunk by chunk with the small products first, c added
    last. int32 [N]. (The tensor cores sum inside a product in their own
    order, so scores agree to f32 rounding, not bit for bit.)"""
    scores = split_scores(h_flat, m) + c.reshape(1, -1)
    return torch.argmin(scores, dim=1).to(torch.int32)


def split_scores(h_flat: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """f32 [N, K] products h @ M as `score_argmin_split_plain` sums them."""
    m_terms = [x.to(torch.float32) for x in split_bf16(_pad_depth(m, 0))]
    if h_flat.dtype == torch.bfloat16:
        h32 = _pad_depth(h_flat.to(torch.float32), 1)
        h_terms = [h32, None, None]
        products = PRODUCTS_BF16_ROWS
    else:
        h_terms = [x.to(torch.float32)
                   for x in split_bf16(_pad_depth(h_flat.to(torch.float32), 1))]
        products = PRODUCTS_F32_ROWS
    h_terms.append(torch.where(torch.isfinite(h_terms[0]), h_terms[0],
                               torch.zeros_like(h_terms[0])))
    scores = torch.zeros((h_flat.shape[0], m.shape[1]), dtype=torch.float32)
    for d in range(0, m_terms[0].shape[0], CHUNK):
        for ht, mt in products:
            scores = scores + h_terms[ht][:, d: d + CHUNK] @ m_terms[mt][d: d + CHUNK]
    return scores


def _check_scores(m: torch.Tensor, c: torch.Tensor) -> None:
    require(m.dim() == 2, f"want M [F, K], got {tuple(m.shape)}")
    k = m.shape[1]
    require(c.numel() == k, f"c has {c.numel()} entries, M has {k} columns")
    require(1 <= k <= MAX_CODES, f"the kernel takes 1 <= K <= {MAX_CODES}; got {k}")
    require(m.dtype == torch.float32 and c.dtype == torch.float32,
             "M and c must be float32")


SMEM_LIMIT = 232448  # bytes of shared memory a block may take on the H100
TILE_ROWS = 64  # rows of one consumer warpgroup's accumulator tile
CONSUMERS = 2  # consumer warpgroups of a block
MAX_A_STAGES = 4  # full-depth row stages a warpgroup may have
MAX_B_STAGES = 4  # stages of the ring of B chunks
BARRIER_BYTES = 8 * (2 * CONSUMERS * MAX_A_STAGES + 2 * MAX_B_STAGES)


@dataclasses.dataclass(frozen=True)
class ScorePlan:
    """How the score kernel lays out one launch's shared memory:
    "resident" (all of M and 2..4 full-depth row stages a warpgroup), "ring"
    (2 full-depth row stages and a ring of B chunks) or "streamed" (a ring of
    stages that each hold a B chunk and the rows' 32 depths of it)."""
    mode: str
    a_stages: int
    b_stages: int
    smem: int


def score_plan(fp: int, kt: int, row_bytes: int) -> Optional[ScorePlan]:
    """The kernel's choice (`launch_nb` in csrc/score_argmin_tc.cu) for rows
    of depth `fp` (a multiple of 32) of `row_bytes` bytes a value at a code
    tile of `kt`; None when no mode fits in SMEM_LIMIT."""
    chunk = 3 * 2 * 16 * kt * 2
    rows = CONSUMERS * TILE_ROWS * fp * row_bytes
    fixed = kt * 4 + BARRIER_BYTES
    nch = fp // CHUNK
    a_stages = MAX_A_STAGES
    while a_stages > 2 and nch * chunk + a_stages * rows + fixed > SMEM_LIMIT:
        a_stages -= 1
    smem = nch * chunk + a_stages * rows + fixed
    if smem <= SMEM_LIMIT:
        return ScorePlan("resident", a_stages, 0, smem)
    if 2 * chunk + 2 * rows + fixed <= SMEM_LIMIT:
        b_stages = min(MAX_B_STAGES, (SMEM_LIMIT - 2 * rows - fixed) // chunk)
        return ScorePlan("ring", 2, b_stages, b_stages * chunk + 2 * rows + fixed)
    stage = chunk + CONSUMERS * TILE_ROWS * CHUNK * row_bytes
    b_stages = min(MAX_B_STAGES, (SMEM_LIMIT - fixed) // stage)
    if b_stages < 2:
        return None
    return ScorePlan("streamed", 0, b_stages, b_stages * stage + fixed)


def _launch_scores(entry: str, wrapper, rows: torch.Tensor, prep: PreparedScores,
                   *flags: int) -> torch.Tensor:
    """Checks shared by the two entry points, then the launches: one per
    code tile, with a running [N] minimum score between them."""
    f, k = prep.m.shape
    require(rows.dim() == 2 and rows.shape[1] == f,
             f"want rows [N, {f}] for M [{f}, {k}], got {tuple(rows.shape)}")
    rows = _pad_depth(rows, 1).contiguous()
    n, fp = rows.shape
    require(rows.data_ptr() % 16 == 0, "rows are not 16-byte aligned")
    kt = prep.tile
    require(score_plan(fp, kt, rows.element_size()) is not None,
            f"no shared-memory plan takes rows of depth {f} at a tile of {kt} "
            f"codes: two stages of a B chunk and 128 rows x {CHUNK} depths "
            f"exceed the {SMEM_LIMIT} B a block gets")
    out = torch.empty(n, dtype=torch.int32, device=rows.device)
    if n:
        best = (torch.empty(n, dtype=torch.float32, device=rows.device)
                if prep.tiles > 1 else None)
        call(entry, rows.device, rows.data_ptr(), *flags, prep.operand.data_ptr(),
              prep.c_tiles.data_ptr(), out.data_ptr(),
              None if best is None else best.data_ptr(), n, fp, k, kt)
        wrapper.launches += prep.tiles
    return out


def fused_score_argmin(h_flat: torch.Tensor,
                       m: Union[torch.Tensor, PreparedScores],
                       c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_flat [N, F] (bf16 or f32), M [F, K] f32, c [1, K] f32 -> int32 [N].
    `m` may be the PreparedScores of (M, c), which saves splitting M on
    every call; `c` is then left out."""
    prepared = isinstance(m, PreparedScores)
    require(prepared == (c is None), "pass M and c, or PreparedScores alone")
    if not on_card(h_flat, m.operand if prepared else m, m.c if prepared else c):
        return score_argmin_plain(h_flat, *((m.m, m.c) if prepared else (m, c)))
    require(h_flat.dtype in (torch.float32, torch.bfloat16),
             f"h must be float32 or bfloat16, got {h_flat.dtype}")
    prep = m if prepared else prepare_scores(m, c)
    return _launch_scores("vq_score_argmin", fused_score_argmin, h_flat, prep,
                          int(h_flat.dtype == torch.bfloat16))


fused_score_argmin.launches = 0


# ---------------------------------------------------------------------------
# Nearest-code search
# ---------------------------------------------------------------------------

def fused_nearest_indices(flat_z: torch.Tensor,
                          codebook: Union[torch.Tensor, PreparedScores]
                          ) -> torch.Tensor:
    """flat_z [N, D] f32, codebook [K, D] (or its `prepare_codebook`)
    -> int32 [N]: argmin_k of ||e_k||^2 - 2 z.e_k, first minimum on ties."""
    prepared = isinstance(codebook, PreparedScores)
    e = codebook.codebook if prepared else codebook
    require(e is not None, "these PreparedScores were not made from a codebook")
    if not on_card(flat_z, e):
        return nearest_indices(flat_z, e).to(torch.int32)
    require(flat_z.dtype == torch.float32,
             f"z must be float32 on the card, got {flat_z.dtype}")
    prep = codebook if prepared else prepare_codebook(codebook)
    return _launch_scores("vq_nearest_indices", fused_nearest_indices, flat_z, prep)


fused_nearest_indices.launches = 0
