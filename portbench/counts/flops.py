"""Floating-point operations per leaf of the plain VQ-VAE, from the sizes a
configuration file lists under "sizes".

A leaf is 8^3 voxels of C channels; the latent grid is 4^3 = 64 positions
of D channels, K codewords. A k^3 conv from a to b channels over p
positions costs 2 p k^3 a b.

Decoder: stem conv k3 D->W, `decoder_blocks` residual blocks of two k3
W->W convs, channel attention (W->W/r->W), up_conv k3 W->8S, then after the
shuffle the final conv k3 S->C over 512 voxels (S = `shuffle_channels`).
Encoder (packed): stem conv k3 8C->W, one residual block (k3 and
`closer_kernel`^3 convs), channel attention, proj 1x1 W->D, and the
distances of the 64 latent rows to the K codewords (2 D K a row).
"""

from __future__ import annotations

from typing import Dict

LATENT_POSITIONS = 64
LEAF_VOXELS = 512


def _conv(positions: int, k: int, a: int, b: int) -> int:
    return 2 * positions * k ** 3 * a * b


def _attention(w: int, r: int) -> int:
    return 2 * w * (w // r) * 2


def decoder_flops(s: Dict) -> int:
    p, w = LATENT_POSITIONS, s["decoder_width"]
    return (_conv(p, 3, s["embedding_dim"], w)
            + s["decoder_blocks"] * 2 * _conv(p, 3, w, w)
            + _attention(w, s["attention_reduction"])
            + _conv(p, 3, w, 8 * s["shuffle_channels"])
            + _conv(LEAF_VOXELS, 3, s["shuffle_channels"], s["in_channels"]))


def encoder_flops(s: Dict) -> int:
    p, w = LATENT_POSITIONS, s["encoder_width"]
    return (_conv(p, 3, 8 * s["in_channels"], w)
            + _conv(p, 3, w, w) + _conv(p, s["closer_kernel"], w, w)
            + _attention(w, s["attention_reduction"])
            + _conv(p, 1, w, s["embedding_dim"])
            + 2 * p * s["embedding_dim"] * s["num_embeddings"])


def flops_per_leaf(sizes: Dict, direction: str) -> int:
    return {"decode": decoder_flops, "encode": encoder_flops}[direction](sizes)


def sizes_from_params(params: Dict, config: Dict) -> Dict:
    """The "sizes" of a packed model as its artifact's weight shapes give
    them (JAX layout: convs DHWIO, linears (in, out))."""
    enc, dec = params["encoder"], params["decoder"]
    return {
        "in_channels": config["in_channels"],
        "embedding_dim": int(params["vq"]["embedding"].shape[-1]),
        "num_embeddings": int(params["vq"]["embedding"].shape[-2]),
        "encoder_width": int(enc["stem_conv"]["w"].shape[-1]),
        "closer_kernel": int(enc["rb"]["conv2"]["w"].shape[0]),
        "decoder_width": int(dec["stem_conv"]["w"].shape[-1]),
        "decoder_blocks": sum(k in dec for k in ("rb", "rb1", "rb2")),
        "attention_reduction": int(dec["attn"]["fc1"]["w"].shape[0] // dec["attn"]["fc1"]["w"].shape[1]),
        "shuffle_channels": int(dec["final"]["w"].shape[-2]),
    }
