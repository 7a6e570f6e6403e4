"""Floating-point operations per leaf of the plain VQ-VAE, from the sizes a
configuration file lists under "sizes".

A leaf is 8^3 voxels of C channels; the latent grid is 4^3 = 64 positions
of D channels, K codewords. A k^3 conv from a to b channels over p output
positions costs 2 p k^3 a b.

Decoder (every architecture's): stem conv k3 D->W, `decoder_blocks`
residual blocks of two k3 W->W convs, channel attention (W->W/r->W), up_conv
k3 W->8S, then after the shuffle the final conv k3 S->C over 512 voxels
(S = `shuffle_channels`). The encoders differ by architecture, so each
plain-reference module (`reference/<name>.py`, a configuration's
"reference") reads its own sizes from the artifact (`sizes`) and counts its
own encoder (`encoder_flops`), the distances of the 64 latent rows to the K
codewords (2 D K a row) included.
"""

from __future__ import annotations

from typing import Dict

from portbench import reference

LATENT_POSITIONS = 64
LEAF_VOXELS = 512


def conv(positions: int, k: int, a: int, b: int) -> int:
    return 2 * positions * k ** 3 * a * b


def attention(w: int, r: int) -> int:
    return 2 * w * (w // r) * 2


def distances(s: Dict) -> int:
    """The 64 latent rows of a leaf against the K codewords."""
    return 2 * LATENT_POSITIONS * s["embedding_dim"] * s["num_embeddings"]


def decoder_flops(s: Dict) -> int:
    p, w = LATENT_POSITIONS, s["decoder_width"]
    return (conv(p, 3, s["embedding_dim"], w)
            + s["decoder_blocks"] * 2 * conv(p, 3, w, w)
            + attention(w, s["attention_reduction"])
            + conv(p, 3, w, 8 * s["shuffle_channels"])
            + conv(LEAF_VOXELS, 3, s["shuffle_channels"], s["in_channels"]))


def flops_per_leaf(sizes: Dict, direction: str, ref: str) -> int:
    """A leaf's operations: the shared decoder's, or the encoder's as the
    reference module `ref` (a configuration's "reference") counts it."""
    if direction == "decode":
        return decoder_flops(sizes)
    return reference.module(ref).encoder_flops(sizes)


def sizes_from_params(params: Dict, config: Dict, ref: str) -> Dict:
    """The "sizes" of an artifact as the reference module `ref` reads them
    from the weight shapes."""
    return reference.module(ref).sizes(params, config)


def decoder_sizes(params: Dict, config: Dict) -> Dict:
    """The sizes every architecture shares: input channels, the codebook and
    the decoder, from the artifact's weight shapes (JAX layout: convs DHWIO,
    linears (in, out))."""
    dec = params["decoder"]
    fc1 = dec["attn"]["fc1"]["w"]
    return {
        "in_channels": config["in_channels"],
        "embedding_dim": int(params["vq"]["embedding"].shape[-1]),
        "num_embeddings": int(params["vq"]["embedding"].shape[-2]),
        "decoder_width": int(dec["stem_conv"]["w"].shape[-1]),
        "decoder_blocks": sum(k in dec for k in ("rb", "rb1", "rb2")),
        "attention_reduction": int(fc1.shape[0] // fc1.shape[1]),
        "shuffle_channels": int(dec["final"]["w"].shape[-2]),
    }
