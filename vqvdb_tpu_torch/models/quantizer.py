"""Vector quantizer: inference and the EMA training quantizer (counterpart
of `vqvdb_tpu/models/quantizer.py`).

`nearest_indices` and `dequantize` are the plain PyTorch versions of the
nearest-code and dequantize kernels (`ops/quantize.py`). The tests hold
them to the JAX package, and the kernels are held to them on the card.

`rvq_indices` and `rvq_dequantize` are the residual-VQ pair: S codebooks
stacked as [S, K, D], stage s coding what stages < s left over. Their
per-stage steps go through the kernels' wrappers (imported inside the
functions: `ops/quantize.py` imports this module), so on the card each
stage launches the nearest-code and dequantize kernels once and on the CPU
their plain versions run.

Training: `VQState` holds the codebook and its EMA statistics (in a params
tree it is the dict `state._asdict()`, as the JAX package serialises it),
with a leading stage axis on every leaf for residual VQ. `vq_train_forward`
and `rvq_train_forward` take the nearest code through the nearest-code
kernel on the detached f32 rows (the codebook moves every step, so it is
prepared anew each call) and the codewords through the dequantize kernel;
both run outside autograd, since the straight-through estimator carries
the gradient to z alone. The EMA statistics are a one-hot product, as in
the JAX package: no float atomics, so a step on the card repeats bit for
bit. Under data parallelism (`group=`, the counterpart of `axis_name`) the
one-hot counts and code sums are summed over the group before the decay
update, per stage for residual VQ and for the perplexity histogram too, and
the number of vectors is the group's (the ranks' shards are equal), so every
rank updates the codebook of the global batch. Random draws come from the
`torch.Generator` the caller passes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from vqvdb_tpu_torch.parallel.distributed import all_reduce_sum, world_size


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


# ---------------------------------------------------------------------------
# EMA training quantizer
# ---------------------------------------------------------------------------

class VQState(NamedTuple):
    """Codebook and EMA statistics: embedding (K, D), cluster_size (K,),
    embed_avg (K, D); (S, K, D) / (S, K) for S residual stages."""

    embedding: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor


def init_vq_state(gen: torch.Generator, num_embeddings: int, embedding_dim: int,
                  dtype=torch.float32) -> VQState:
    """Random-normal, row-normalised codebook on the generator's device."""
    embed = torch.empty((num_embeddings, embedding_dim), dtype=dtype,
                        device=gen.device).normal_(generator=gen)
    embed = embed / torch.linalg.vector_norm(embed, dim=1, keepdim=True)
    return VQState(embedding=embed,
                   cluster_size=torch.ones((num_embeddings,), dtype=dtype, device=gen.device),
                   embed_avg=embed.clone())


def pairwise_sq_distances(flat_z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, K] squared L2 distances in f32 (the JAX package's formula)."""
    z = flat_z.to(torch.float32)
    e = codebook.to(torch.float32)
    return (z * z).sum(dim=1, keepdim=True) + (e * e).sum(dim=1)[None, :] - 2.0 * (z @ e.T)


def batch_stats(flat_z: torch.Tensor, indices: torch.Tensor, num_embeddings: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-code counts (K,) and per-code sums (K, D) in f32, as a one-hot
    product (deterministic on the card, unlike a scatter of floats)."""
    codes = torch.arange(num_embeddings, device=indices.device)
    one_hot = (indices.reshape(-1, 1).to(torch.int64) == codes).to(torch.float32)
    return one_hot.sum(dim=0), one_hot.T @ flat_z.to(torch.float32)


def ema_update(state: VQState, counts: torch.Tensor, sums: torch.Tensor,
               decay: float, eps: float) -> VQState:
    """cluster_size <- decay cs + (1 - decay) counts; embed_avg likewise with
    sums; embedding <- embed_avg / max(cluster_size, eps)."""
    new_cs = state.cluster_size * decay + (1.0 - decay) * counts
    new_ea = state.embed_avg * decay + (1.0 - decay) * sums
    return VQState(embedding=new_ea / torch.clamp(new_cs, min=eps)[:, None],
                   cluster_size=new_cs, embed_avg=new_ea)


def _nearest_and_rows(rows: torch.Tensor, codebook: torch.Tensor, dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 nearest codes of the f32 rows, their codewords in `dtype`),
    through the kernels' wrappers."""
    from vqvdb_tpu_torch.ops.quantize import fused_dequantize, fused_nearest_indices

    idx = fused_nearest_indices(rows.detach().to(torch.float32).contiguous(), codebook)
    return idx, fused_dequantize(idx, codebook.to(dtype))


def _perplexity(counts: torch.Tensor, n_vectors: int) -> torch.Tensor:
    avg = counts / max(float(n_vectors), 1.0)
    return torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))


def _global_stats(counts: torch.Tensor, sums: torch.Tensor, group):
    """counts and sums summed over `group` in one all-reduce (as they are
    without one)."""
    if group is None:
        return counts, sums
    return tuple(all_reduce_sum([counts, sums], group))


def vq_train_forward(state: VQState, z: torch.Tensor, commitment_cost: float,
                     decay: float, eps: float, *, group=None
                     ) -> Tuple[torch.Tensor, VQState, torch.Tensor, torch.Tensor]:
    """Training quantizer pass on channels-last latents z (..., D).
    Returns (quantized with the straight-through estimator, new state,
    commitment loss, perplexity). With `group` the EMA statistics and the
    perplexity histogram are the group's sums; the commitment loss stays
    the local mean (the step averages it with the other metrics)."""
    d = z.shape[-1]
    flat = z.reshape(-1, d)
    with torch.no_grad():
        idx, quant_flat = _nearest_and_rows(flat, state.embedding, z.dtype)
        quantized = quant_flat.reshape(z.shape)
        counts, sums = _global_stats(*batch_stats(flat.detach(), idx,
                                                  state.embedding.shape[0]), group)
        new_state = ema_update(state, counts, sums, decay, eps)
        perplexity = _perplexity(counts, flat.shape[0] * world_size(group))
    commitment = commitment_cost * torch.mean(
        torch.square(z.to(torch.float32) - quantized.to(torch.float32)))
    return z + (quantized - z).detach(), new_state, commitment, perplexity


def reset_dead_codes(gen: torch.Generator, state: VQState, flat_z: torch.Tensor,
                     threshold: float = 1.0) -> Tuple[VQState, torch.Tensor]:
    """Codes with cluster_size < threshold take a random row of flat_z
    (every code draws one; only dead codes keep it). Returns (new state,
    number of dead codes as a 0-d tensor: reading it waits for the device)."""
    k = state.embedding.shape[0]
    dead = state.cluster_size < threshold
    sample = torch.randint(0, flat_z.shape[0], (k,), generator=gen, device=gen.device)
    candidates = flat_z.to(state.embedding.dtype)[sample.to(flat_z.device)]
    col = dead[:, None]
    return (VQState(torch.where(col, candidates, state.embedding),
                    torch.where(dead, torch.ones_like(state.cluster_size), state.cluster_size),
                    torch.where(col, candidates, state.embed_avg)),
            dead.sum())


def _stage(state: VQState, s: int) -> VQState:
    return VQState(state.embedding[s], state.cluster_size[s], state.embed_avg[s])


def _stack(stages: Sequence[VQState]) -> VQState:
    return VQState(*(torch.stack(leaves) for leaves in zip(*stages)))


def init_rvq_state(gen: torch.Generator, num_stages: int, num_embeddings: int,
                   embedding_dim: int, dtype=torch.float32) -> VQState:
    """Stage-stacked VQState; each stage drawn like init_vq_state."""
    return _stack([init_vq_state(gen, num_embeddings, embedding_dim, dtype)
                   for _ in range(num_stages)])


def rvq_train_forward(state: VQState, z: torch.Tensor, commitment_cost: float,
                      decay: float, eps: float, *, group=None
                      ) -> Tuple[torch.Tensor, VQState, torch.Tensor, torch.Tensor]:
    """Residual-VQ training pass, same contract as vq_train_forward: each
    stage runs the EMA update on the residual it codes (its statistics
    summed over `group`); one straight-through estimator on the summed
    codewords; commitment is the stages' mean of beta * MSE(residual,
    sg[stage codewords]); perplexity of stage 0."""
    d = z.shape[-1]
    s_total = state.embedding.shape[0]
    res = z.reshape(-1, d).to(torch.float32)
    q_total = torch.zeros_like(res.detach())
    stages, commitment, perplexity0 = [], 0.0, None
    for s in range(s_total):
        st = _stage(state, s)
        with torch.no_grad():
            idx, q = _nearest_and_rows(res, st.embedding, torch.float32)
            counts, sums = _global_stats(*batch_stats(res.detach(), idx,
                                                      st.embedding.shape[0]), group)
            stages.append(ema_update(st, counts, sums, decay, eps))
            if s == 0:
                perplexity0 = _perplexity(counts, res.shape[0] * world_size(group))
        commitment = commitment + commitment_cost * torch.mean(torch.square(res - q))
        res = res - q
        q_total = q_total + q
    quantized = q_total.reshape(z.shape).to(z.dtype)
    return (z + (quantized - z).detach(), _stack(stages), commitment / s_total,
            perplexity0)


def rvq_reset_dead_codes(gen: torch.Generator, state: VQState, flat_z: torch.Tensor,
                         threshold: float = 1.0) -> Tuple[VQState, torch.Tensor]:
    """Per-stage dead-code reset: stage s resamples from the residual that
    stages < s leave of flat_z (what that stage codes)."""
    res = flat_z.to(torch.float32)
    stages, total = [], 0
    for s in range(state.embedding.shape[0]):
        new_st, n_dead = reset_dead_codes(gen, _stage(state, s), res, threshold)
        stages.append(new_st)
        total = total + n_dead
        _, q = _nearest_and_rows(res, new_st.embedding, torch.float32)
        res = res - q
    return _stack(stages), total
