"""The decoder's head as one hand-written kernel: the channel-attention gate,
the folded tail product, its bias and the head activation.

    gate = bf16(sigmoid(relu(mean(h) @ W1) @ W2));  x = bf16(h * gate)
    out  = act(x @ bf16(K) + b)        (f32 sums; act sigmoid or tanh)

for h (B, 4, 4, 4, C_in) bf16 -> (B, 8, 8, 8, C_out) f32, with K, b the folded
tail (`ops/tail.py::fold_decoder_tail`); for h in f32 the same in f32
throughout (the gate and the gated row unrounded, K the f32 fold).
`prepare_head` builds what the head reads once a model (the codec's
`init/tail_fold`): the fold's bias, the attention's weights in f32 and the
operator the step multiplies by. `decoder_head_fused` is the wrapper of
`csrc/decoder_head.cu` and what the codec's decode step calls: on a CUDA
tensor it launches the kernel (two launches: the gate, then the product; on
the tensor cores for bf16 features, on the CUDA cores for f32 ones) or
raises, on a CPU tensor it returns `decoder_head_plain`, the eager
`blocks.channel_attention` and `apply_decoder_tail`. It counts its kernel
launches in `decoder_head_fused.launches`.

The kernel repeats the eager version's roundings one for one; only the
order of its sums moves, and that order is fixed by the kernel, not by how
many rows share a call, so a leaf gets the same bits in a batch of any size
without `blocks.row_blocks` or `padded_rows`.
"""

from __future__ import annotations

from typing import Dict

import torch

from vqvdb_tpu_torch.core.config import LATENT_DIM, LATENT_VOXELS, LEAF_DIM, ModelConfig
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.models.vqvae import head_activation_name
from vqvdb_tpu_torch.ops.build import call, on_card
from vqvdb_tpu_torch.ops.tail import apply_decoder_tail, fold_decoder_tail
from vqvdb_tpu_torch.utils.profiler import span

WIDTHS = (64, 128)  # C_in the kernel takes: every shipped decoder's
ACTIVATIONS = ("sigmoid", "tanh")  # the kernel's `act` 0 and 1
K_STEP = 16  # depth of one wgmma step
CHUNK = 32   # depth a thread reads 8 values of per row


def head_plan(n_out: int) -> int:
    """Columns of the kernel's output tile for N = n_out outputs a row: 192
    where it divides N (vec3's 1,536: 8 column tiles, 256 tiles over the
    card's 132 SMs at 4,096 rows), else 128 (the flagship's 512). It depends
    on N alone, never on the rows."""
    if n_out <= 0 or n_out % 128:
        raise ValueError(f"the head's outputs a row ({n_out}) must be a multiple of 128")
    return 192 if n_out % 192 == 0 else 128


def operator_depths(depth: int) -> torch.Tensor:
    """The operator row (depth) that each MMA depth of the kernel reads:
    (depth / 16, 16). In a 32-deep chunk a thread reads its 8 values at
    depths 8t .. 8t + 7; step u of the chunk takes values 4u .. 4u + 3, the
    first pair as MMA depths 2t, 2t + 1, the second as 2t + 8, 2t + 9."""
    j = torch.arange(K_STEP)
    q = torch.arange(depth // K_STEP)
    thread = (j % 8) // 2
    value = 4 * (q % 2)[:, None] + (j % 2 + 2 * (j // 8))[None, :]
    return CHUNK * (q // 2)[:, None] + 8 * thread[None, :] + value


def operator_tiles(k: torch.Tensor) -> torch.Tensor:
    """The folded operator K (depth, N) f32 rounded to bf16 in the order the
    kernel loads it: per column tile of `head_plan(N)` columns, per 64-deep
    stage, per k16 step q, per group of 8 columns, the two 8-deep halves of
    an 8 x 8 core matrix (8 columns of 8 contiguous depths), the depths
    permuted by `operator_depths`. Shape (N / BN, depth / 64, 4, BN / 8, 2,
    8, 8): a stage of a column tile is one contiguous run."""
    depth, n_out = k.shape
    bn = head_plan(n_out)
    rows = operator_depths(depth).to(k.device).reshape(-1)
    kb = k.to(torch.bfloat16)[rows].reshape(depth // 64, 4, 2, 8, n_out // bn, bn // 8, 8)
    # (stage, step, half, depth, tile, group, column) -> (tile, stage, step, group, half,
    # column, depth)
    return kb.permute(4, 0, 1, 5, 2, 6, 3).contiguous()


def prepare_head(decoder_params: Dict, cfg: ModelConfig,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """What the head of a `dtype` step reads, made once a model on the
    params' device: 'b' (the fold's bias, f32), 'w1', 'w2' (the attention's
    fc1 (C_in, H) and fc2 (H, C_in) weights, f32), and the one operator the
    step multiplies by: 'op' (`operator_tiles` of the fold) for bf16 on the
    card, else 'k' (the fold, f32), which the f32 kernel and the plain
    version read."""
    fold = fold_decoder_tail(decoder_params, cfg)
    head = {"b": fold["b"]}
    if dtype == torch.bfloat16 and fold["k"].is_cuda:
        head["op"] = operator_tiles(fold["k"])
    else:
        head["k"] = fold["k"]
    attn = decoder_params["attn"]
    head["w1"] = attn["fc1"]["w"].to(torch.float32).contiguous()
    head["w2"] = attn["fc2"]["w"].to(torch.float32).contiguous()
    return head


def decoder_head_plain(head: Dict[str, torch.Tensor], h: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """Plain version of the kernel: the eager channel attention, then the
    folded tail's product, bias and activation (the trace ranges
    `decode/attention` and `decode/tail`: each part's ops lie near the range
    that holds them)."""
    attn = {"fc1": {"w": head["w1"]}, "fc2": {"w": head["w2"]}}
    with span("decode/attention"):
        gated = blocks.channel_attention(attn, h)
    with span("decode/tail"):
        return apply_decoder_tail(head, gated, cfg)


def decoder_head_fused(head: Dict[str, torch.Tensor], h: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """The head for h (B, 4, 4, 4, C_in) bf16 or f32, dense: (B, 8, 8, 8,
    C_out) f32, with `head` as `prepare_head` made it for h's dtype. The
    checks of the features and weights are the kernel's on either device,
    those of the operator on the card; their messages are made only when one
    fails (the decode step's host time counts)."""
    w1, w2, bias = head["w1"], head["w2"], head["b"]
    b, c, hid, n_out = h.shape[0], h.shape[-1], w1.shape[1], bias.shape[0]
    if h.dtype != torch.bfloat16 and h.dtype != torch.float32:
        raise ValueError(f"h must be bfloat16 or float32, got {h.dtype}")
    if h.dim() != 5 or h.shape[1:4] != (LATENT_DIM,) * 3 or not h.is_contiguous():
        raise ValueError(f"want h dense (B, 4, 4, 4, C_in), got {tuple(h.shape)} with strides "
                         f"{h.stride()}; the kernel makes no copy")
    if c not in WIDTHS:
        raise ValueError(f"the head takes C_in in {WIDTHS}, got {c}")
    if (w1.shape != (c, hid) or w2.shape != (hid, c) or hid < 1 or c % hid
            or w1.dtype != torch.float32 or w2.dtype != torch.float32
            or not (w1.is_contiguous() and w2.is_contiguous())):
        raise ValueError(f"attention weights {tuple(w1.shape)} {w1.dtype}, {tuple(w2.shape)} "
                         f"{w2.dtype} are not dense f32 weights of C_in {c} (H dividing C_in)")
    if (n_out != LEAF_DIM ** 3 * cfg.in_channels or bias.dtype != torch.float32
            or not bias.is_contiguous()):
        raise ValueError(f"the bias ({n_out} {bias.dtype}) is not 8^3 x {cfg.in_channels} f32 "
                         "voxels")
    if not on_card(h, w1, w2, bias):
        return decoder_head_plain(head, h, cfg)
    act = ACTIVATIONS.index(head_activation_name(cfg))
    depth = LATENT_VOXELS * c
    if h.dtype == torch.bfloat16:
        op, bn = head.get("op"), head_plan(n_out)
        if (op is None or op.shape != (n_out // bn, depth // 64, 4, bn // 8, 2, 8, 8)
                or op.dtype != torch.bfloat16 or not op.is_contiguous() or op.device != h.device):
            raise ValueError("the head has no `operator_tiles` of its fold for a bf16 step")
    else:
        k = head.get("k")
        if (k is None or k.shape != (depth, n_out) or k.dtype != torch.float32
                or not k.is_contiguous() or k.device != h.device):
            raise ValueError("the head has no dense f32 fold for an f32 step")
    out = torch.empty((b,) + (LEAF_DIM,) * 3 + (cfg.in_channels,), dtype=torch.float32,
                      device=h.device)
    if b:
        gate = torch.empty((b, c), dtype=h.dtype, device=h.device)
        if h.dtype == torch.bfloat16:
            call("vq_decoder_head", h.device, h.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 gate.data_ptr(), op.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, hid,
                 n_out, bn, act)
        else:
            call("vq_decoder_head_f32", h.device, h.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 gate.data_ptr(), k.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, hid,
                 n_out, act)
        decoder_head_fused.launches += 2
    return out


decoder_head_fused.launches = 0
