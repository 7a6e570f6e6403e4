"""VQ-VAE graphs and their training half (counterpart of
`vqvdb_tpu/models/vqvae.py`).

Every encoder of the JAX package: the packed encoders (`encoder_arch`
"packed" and "packed_lite", which differ only in the residual block's
closer kernel; "packed_stem", which adds an 8^3 stage before the pack;
scalar and vec3 inputs), the reference encoders (scalar and vec3, with the
strided conv as it is or folded onto the packed grid), and both decoders.

  packed enc:   s2c(2) (8,8,8,C)->(4,4,4,8C) | conv k3 8C->W GN(8) relu
                | RB(W) | CA(W) | proj 1x1 W->D        (W = 64 scalar, 128 vec3)
  packed_stem:  conv k3 C->W/8 GN(W/16) relu | s2c(2) -> (4,4,4,W)
                | conv k1 W->W GN(8) relu | RB(W) | CA(W) | proj 1x1 W->D
  reference enc, scalar:
                conv k3 1->16 GN(4) relu | RB(16) | conv k4 s2 16->32
                | RB(32) | CA(32) | proj 1x1 32->D
  reference enc, vec3:
                conv k3 3->64 GN(8) relu | RB(64) | conv k3 s2 64->128
                | RB(128) | RB(128) | CA(128) | proj 1x1 128->D
  scalar dec:   conv k3 D->64 GN(8) relu | RB(64) | CA(64)
                | up_conv k3 64->256 | pixel_shuffle(2) | conv k3 32->1 | sigmoid
  vec3 dec:     conv k3 D->128 GN(8) relu | RB(128) | RB(128) | CA(128)
                | up_conv k3 128->256 | pixel_shuffle(2) | conv k3 32->3 | tanh

Inference without the codec's folds: `encode_to_indices` /
`decode_from_indices` (the export validation and the interop tests call
them). Training: `init_vqvae_params` draws a params
tree (encoder / decoder / vq, convs OIDHW channels-last, the JAX layout
otherwise) from a `torch.Generator`; `vqvae_forward` is the training
forward with the EMA quantizer. Training runs the eager residual block, as
the JAX package does: the fused-block kernel is an inference path and has
no backward. So is the GroupNorm kernel: each GroupNorm and the ReLU after
it go through `blocks.group_norm_relu`, one launch on the card at
inference, the eager form otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.models.quantizer import (
    VQState,
    init_rvq_state,
    init_vq_state,
    reset_dead_codes,
    rvq_dequantize,
    rvq_indices,
    rvq_reset_dead_codes,
    rvq_train_forward,
    vq_train_forward,
)
from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused
from vqvdb_tpu_torch.ops.packed import space_to_channel
from vqvdb_tpu_torch.utils.errors import ConfigError
from vqvdb_tpu_torch.utils.profiler import device_stage, span

Params = Dict[str, Any]


def encoder_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The encoder tree's top-level keys for `cfg`, in the tree's order."""
    if cfg.encoder_arch.startswith("packed"):
        stem = ("pre_conv", "pre_gn") if cfg.encoder_arch == "packed_stem" else ()
        return stem + ("stem_conv", "stem_gn", "rb", "attn", "proj")
    if cfg.variant == "scalar":
        return ("pre_conv", "pre_gn", "pre_rb", "down", "rb", "attn", "proj")
    return ("pre_conv", "pre_gn", "pre_rb", "down", "rb1", "rb2", "attn", "proj")


def check_tree(params: Params, cfg: ModelConfig) -> None:
    """Raise ConfigError when the params' encoder is not the graph `cfg`
    names (a packed tree under a packed_stem config, say)."""
    got, want = sorted(params["encoder"]), sorted(encoder_keys(cfg))
    if got != want:
        raise ConfigError(f"the encoder tree {got} is not the {cfg.encoder_arch} "
                          f"{cfg.variant} encoder {want}")


def _encoder_features_packed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Packed-encoder features: (B,8,8,8,C) -> (B,4,4,4,W). packed_stem runs
    its 8^3 stage (k3 conv C -> W/8, GroupNorm of W/16 groups, relu) first,
    so the pack lands on W channels and the stem conv is k1."""
    with span("encode/stem"):
        h = x
        if "pre_conv" in params:
            h = blocks.conv3d(params["pre_conv"], h, padding=1)
            h = blocks.group_norm_relu(params["pre_gn"], h,
                                       params["pre_gn"]["scale"].shape[0] // 2)
        h = space_to_channel(h, 2)
        h = blocks.conv3d(params["stem_conv"], h,
                          padding=blocks.same_padding(params["stem_conv"]))
        h = blocks.group_norm_relu(params["stem_gn"], h, 8)
    with span("encode/rb"):
        h = blocks.residual_block(params["rb"], h)
    with span("encode/attention"):
        return blocks.channel_attention(params["attn"], h)


def _reference_pre(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   fuse_rb16: bool = False) -> torch.Tensor:
    """The reference encoders' stage on the 8^3 grid: conv, GroupNorm (4
    groups scalar, 8 vec3), relu, residual block; the device stage
    `device/encode_fine` in a traced codec batch on the card."""
    with device_stage("device/encode_fine", x):
        with span("encode/pre_conv"):
            h = blocks.conv3d(params["pre_conv"], x, padding=1)
            pre_groups = 4 if cfg.variant == "scalar" else 8
            h = blocks.group_norm_relu(params["pre_gn"], h, pre_groups)
        with span("encode/pre_rb"):
            if fuse_rb16:
                # The kernel reads a dense NDHWC buffer; a no-op when GroupNorm
                # already handed one over.
                return residual_block_fused(params["pre_rb"], h.contiguous())
            return blocks.residual_block(params["pre_rb"], h)


def _reference_post(params: Params, h: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The reference encoders' stage on the 4^3 grid, after the down conv."""
    for key in ("rb",) if cfg.variant == "scalar" else ("rb1", "rb2"):
        with span(f"encode/{key}"):
            h = blocks.residual_block(params[key], h)
    with span("encode/attention"):
        return blocks.channel_attention(params["attn"], h)


def encoder_features(params: Params, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Encoder up to (excluding) the 1x1 projection:
    (B,8,8,8,C) -> (B,4,4,4,32|64|128)."""
    if cfg.encoder_arch.startswith("packed"):
        return _encoder_features_packed(params, x)
    h = _reference_pre(params, x, cfg)
    # k4 s2 (scalar) / k3 s2 (vec3): 8^3 -> 4^3
    with span("encode/down"):
        h = blocks.conv3d(params["down"], h, stride=2, padding=1)
    return _reference_post(params, h, cfg)


def encoder_apply(params: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """x (B,8,8,8,C) -> latents (B,4,4,4,D)."""
    h = encoder_features(params, x, cfg)
    with span("encode/proj"):
        return blocks.conv3d(params["proj"], h)


def encoder_features_packed_down(params: Params, folded_down: Params,
                                 x: torch.Tensor, cfg: ModelConfig,
                                 fuse_rb16: bool = False) -> torch.Tensor:
    """Reference encoder only: `encoder_features` with the strided conv run
    as a k3 SAME conv on the space-to-channel grid (`folded_down` from
    ops/packed.py::fold_strided_conv; an exact rewrite). `fuse_rb16` runs
    the scalar variant's 16-channel residual block as one kernel
    (ops/fused_rb.py)."""
    h = _reference_pre(params, x, cfg,
                       fuse_rb16=fuse_rb16 and cfg.variant == "scalar")
    with span("encode/down"):
        h = blocks.conv3d(folded_down, space_to_channel(h, 2), padding=1)
    return _reference_post(params, h, cfg)


def decoder_trunk(params: Params, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decoder up to (excluding) its channel attention: (B,4,4,4,D) ->
    (B,4,4,4,64|128). The codec's decode step runs the head after it
    (`ops/decoder_head.py`)."""
    with span("decode/stem"):
        h = blocks.conv3d(params["stem_conv"], z, padding=1)
        h = blocks.group_norm_relu(params["stem_gn"], h, 8)
    return _decoder_blocks(params, h, cfg)


def decoder_pre_tail(params: Params, z: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Decoder up to (excluding) up_conv: (B,4,4,4,D) -> (B,4,4,4,64|128)."""
    return _decoder_attention(params, decoder_trunk(params, z, cfg))


def _decoder_after_stem_conv(params: Params, h: torch.Tensor, cfg: ModelConfig
                             ) -> torch.Tensor:
    """The decoder after its stem conv, up to (excluding) up_conv."""
    with span("decode/stem"):
        h = blocks.group_norm_relu(params["stem_gn"], h, 8)
    return _decoder_attention(params, _decoder_blocks(params, h, cfg))


def _decoder_blocks(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's residual blocks."""
    for key in ("rb",) if cfg.variant == "scalar" else ("rb1", "rb2"):
        with span(f"decode/{key}"):
            h = blocks.residual_block(params[key], h)
    return h


def _decoder_attention(params: Params, h: torch.Tensor) -> torch.Tensor:
    with span("decode/attention"):
        return blocks.channel_attention(params["attn"], h)


def head_activation_name(cfg: ModelConfig) -> str:
    """The decoder head's activation: "sigmoid" (scalar) or "tanh" (vec3)."""
    return "sigmoid" if cfg.variant == "scalar" else "tanh"


def head_activation(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """`head_activation_name(cfg)` of the f32 logits."""
    h = h.to(torch.float32)
    return torch.sigmoid(h) if head_activation_name(cfg) == "sigmoid" else torch.tanh(h)


def decoder_tail(params: Params, h: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """up_conv -> pixel shuffle -> final conv -> head activation:
    (B,4,4,4,64|128) -> (B,8,8,8,C) f32."""
    with span("decode/tail"):
        h = blocks.conv3d(params["up_conv"], h, padding=1)
        h = blocks.pixel_shuffle_3d(h, 2)
        h = blocks.conv3d(params["final"], h, padding=1)
        return head_activation(h, cfg)


def decoder_apply(params: Params, z: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """z (B,4,4,4,D) -> reconstruction (B,8,8,8,C) f32."""
    return decoder_tail(params, decoder_pre_tail(params, z, cfg), cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def packed_encoder_width(cfg: ModelConfig) -> int:
    """Channel width of the packed encoders: 64 scalar, 128 vec3."""
    return 64 if cfg.variant == "scalar" else 128


def _init_encoder(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    b = blocks
    c = cfg.in_channels
    if cfg.encoder_arch.startswith("packed"):
        w = packed_encoder_width(cfg)
        kernel2 = 1 if cfg.encoder_arch == "packed_lite" else 3
        out: Params = {}
        stem_in, stem_kernel = c * 8, 3
        if cfg.encoder_arch == "packed_stem":
            out["pre_conv"] = b.init_conv3d(gen, c, w // 8, 3, dtype=dtype)
            out["pre_gn"] = b.init_group_norm(w // 8, dtype, gen.device)
            stem_in, stem_kernel = w, 1
        out.update({
            "stem_conv": b.init_conv3d(gen, stem_in, w, stem_kernel, dtype=dtype),
            "stem_gn": b.init_group_norm(w, dtype, gen.device),
            "rb": b.init_residual_block(gen, w, dtype, kernel2=kernel2),
            "attn": b.init_channel_attention(gen, w, dtype=dtype),
            "proj": b.init_conv3d(gen, w, cfg.embedding_dim, 1, dtype=dtype),
        })
        return out
    if cfg.variant == "scalar":
        return {
            "pre_conv": b.init_conv3d(gen, c, 16, 3, dtype=dtype),
            "pre_gn": b.init_group_norm(16, dtype, gen.device),
            "pre_rb": b.init_residual_block(gen, 16, dtype),
            "down": b.init_conv3d(gen, 16, 32, 4, dtype=dtype),
            "rb": b.init_residual_block(gen, 32, dtype),
            "attn": b.init_channel_attention(gen, 32, dtype=dtype),
            "proj": b.init_conv3d(gen, 32, cfg.embedding_dim, 1, dtype=dtype),
        }
    return {
        "pre_conv": b.init_conv3d(gen, c, 64, 3, dtype=dtype),
        "pre_gn": b.init_group_norm(64, dtype, gen.device),
        "pre_rb": b.init_residual_block(gen, 64, dtype),
        "down": b.init_conv3d(gen, 64, 128, 3, dtype=dtype),
        "rb1": b.init_residual_block(gen, 128, dtype),
        "rb2": b.init_residual_block(gen, 128, dtype),
        "attn": b.init_channel_attention(gen, 128, dtype=dtype),
        "proj": b.init_conv3d(gen, 128, cfg.embedding_dim, 1, dtype=dtype),
    }


def _init_decoder(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    b = blocks
    w = 64 if cfg.variant == "scalar" else 128
    out = {
        "stem_conv": b.init_conv3d(gen, cfg.embedding_dim, w, 3, dtype=dtype),
        "stem_gn": b.init_group_norm(w, dtype, gen.device),
    }
    if cfg.variant == "scalar":
        out["rb"] = b.init_residual_block(gen, w, dtype)
    else:
        out["rb1"] = b.init_residual_block(gen, w, dtype)
        out["rb2"] = b.init_residual_block(gen, w, dtype)
    out["attn"] = b.init_channel_attention(gen, w, dtype=dtype)
    out["up_conv"] = b.init_conv3d_icnr(gen, w, 32 * 8, 3, dtype=dtype)
    out["final"] = b.init_conv3d(gen, 32, cfg.in_channels, 3, dtype=dtype)
    return out


def init_vqvae_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype=torch.float32) -> Params:
    """A params tree {encoder, decoder, vq} drawn from `gen`, on its device,
    with the JAX package's keys in its order."""
    enc = _init_encoder(gen, cfg, dtype)
    dec = _init_decoder(gen, cfg, dtype)
    if cfg.num_quantizers > 1:
        vq = init_rvq_state(gen, cfg.num_quantizers, cfg.num_embeddings,
                            cfg.embedding_dim, dtype)
    else:
        vq = init_vq_state(gen, cfg.num_embeddings, cfg.embedding_dim, dtype)
    return {"encoder": enc, "decoder": dec, "vq": vq._asdict()}


# ---------------------------------------------------------------------------
# Quantizer dispatch and the training forward
# ---------------------------------------------------------------------------

def quantize_infer(vq: VQState, flat: torch.Tensor, cfg: ModelConfig,
                   compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat latents (N, D) -> (int32 indices (N,) or (N, S), codewords (N, D)
    in compute_dtype), through the nearest-code and dequantize kernels."""
    from vqvdb_tpu_torch.ops.quantize import fused_dequantize, fused_nearest_indices

    rows = flat.detach().to(torch.float32).contiguous()
    if cfg.num_quantizers > 1:
        idx = rvq_indices(rows, vq.embedding)
        return idx, rvq_dequantize(idx, vq.embedding.to(compute_dtype))
    idx = fused_nearest_indices(rows, vq.embedding)
    return idx, fused_dequantize(idx, vq.embedding.to(compute_dtype))


def encode_to_indices(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Inference encode on x's device: leaves (B,8,8,8,C) -> indices
    (B,4,4,4), or (B,4,4,4,S) for residual-VQ models; uint8 for K <= 256,
    else uint16, as the JAX package returns them. On the card through the
    nearest-code and dequantize kernels (`quantize_infer`)."""
    z = encoder_apply(params["encoder"], x, cfg)
    idx, _ = quantize_infer(VQState(**params["vq"]), z.reshape(-1, cfg.embedding_dim), cfg)
    idx = idx.reshape((z.shape[0],) + cfg.index_shape)
    return idx.to(torch.uint8 if cfg.num_embeddings <= 256 else torch.uint16)


# Blocks per call of the dequantize kernel in decode_from_indices: its rows
# are 27 * W floats (7 KB scalar, 14 KB vec3) per latent position.
DECODE_CHUNK = 1024


def _stem_from_indices(stem: Params, codebooks: torch.Tensor, idx: torch.Tensor,
                       cfg: ModelConfig, compute_dtype) -> torch.Tensor:
    """The decoder's k3 SAME stem conv of the dequantized indices, as its
    exact rewrite: per tap t the projected codebook E @ W_t ([K, W]; D
    products summed in f32), looked up by the dequantize kernel (once per
    stage), and the 27 taps' rows of the neighbouring positions summed in a
    fixed order, plus the bias. idx [B, *latent, S] int -> (B,4,4,4,W) in
    compute_dtype. The direct f32 conv sums 27 D = 3,456 products a value
    and put the flagship's decode ~1e-5 from an f64 reference on the CPU
    and the card; this form stays within ~3e-6."""
    from vqvdb_tpu_torch.ops.quantize import fused_dequantize

    w = stem["w"]  # OIDHW
    width, k = w.shape[0], w.shape[2]
    taps = w.to(compute_dtype).to(torch.float32).permute(1, 2, 3, 4, 0).reshape(
        cfg.embedding_dim, k ** 3 * width)
    b, (d, h, wd) = idx.shape[0], cfg.latent_shape
    rows = None
    for s, e in enumerate(codebooks.reshape(-1, cfg.num_embeddings, cfg.embedding_dim)):
        table = e.to(compute_dtype).to(torch.float32) @ taps  # [K, 27 W]
        r = fused_dequantize(idx[..., s].reshape(-1).contiguous(), table)
        rows = r if rows is None else rows + r
    pad = k // 2
    padded = rows.new_zeros((b, d + 2 * pad, h + 2 * pad, wd + 2 * pad, k, k, k, width))
    padded[:, pad:pad + d, pad:pad + h, pad:pad + wd] = rows.reshape(b, d, h, wd, k, k, k, width)
    out = None
    for a in range(k):
        for c in range(k):
            for e_ in range(k):
                t = padded[:, a:a + d, c:c + h, e_:e_ + wd, a, c, e_]
                out = t if out is None else out + t
    return (out + stem["b"].to(compute_dtype).to(torch.float32)).to(compute_dtype)


def decode_from_indices(params: Params, indices: torch.Tensor, cfg: ModelConfig,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Inference decode on the indices' device: (B,4,4,4[,S]) indices of any
    integer dtype -> leaves (B,8,8,8,C) f32: the stem conv of the looked-up
    codewords through the dequantize kernel (`_stem_from_indices`), then the
    rest of the unfolded decoder, DECODE_CHUNK blocks at a time."""
    idx = indices if indices.dtype == torch.uint8 else indices.to(torch.int32)
    idx = idx.reshape((idx.shape[0],) + cfg.latent_shape + (cfg.num_quantizers,))
    dec = params["decoder"]
    out = []
    for s in range(0, idx.shape[0], DECODE_CHUNK):
        h = _stem_from_indices(dec["stem_conv"], params["vq"]["embedding"],
                               idx[s:s + DECODE_CHUNK], cfg, compute_dtype)
        out.append(decoder_tail(dec, _decoder_after_stem_conv(dec, h, cfg), cfg))
    return torch.cat(out) if len(out) != 1 else out[0]


def quantize_train_forward(vq: VQState, z: torch.Tensor, cfg: ModelConfig, *, group=None):
    """Single-stage EMA or residual-VQ training pass (vq_train_forward's
    contract; `group` sums the EMA statistics over a process group)."""
    fwd = rvq_train_forward if cfg.num_quantizers > 1 else vq_train_forward
    return fwd(vq, z, cfg.commitment_cost, cfg.ema_decay, cfg.ema_eps, group=group)


def reset_dead(gen: torch.Generator, vq: VQState, flat_z: torch.Tensor,
               cfg: ModelConfig, threshold: float = 1.0):
    """Dead-code reset (per-stage residual inputs for residual VQ)."""
    fn = rvq_reset_dead_codes if cfg.num_quantizers > 1 else reset_dead_codes
    return fn(gen, vq, flat_z, threshold)


def vqvae_forward(params: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, VQState, torch.Tensor, torch.Tensor]:
    """Training forward: (z, recon, new VQState, vq_loss, perplexity)."""
    z = encoder_apply(params["encoder"], x, cfg)
    quantized, new_vq, vq_loss, perplexity = quantize_train_forward(
        VQState(**params["vq"]), z, cfg)
    recon = decoder_apply(params["decoder"], quantized, cfg)
    return z, recon, new_vq, vq_loss, perplexity
