"""Plain reference of upstream's strided-conv encoders (`encoder_arch`
"reference"): `EncoderFloat` for scalar leaves (upstream
python/VQVAE_v2.py:231-250) and `EncoderVec3` for vec3 leaves (:278-300).

  scalar: conv k3 1->16, GroupNorm(4), relu | RB(16) | conv k4 s2 16->32
          | RB(32) | CA(32) | proj 1x1 32->D
  vec3:   conv k3 3->64, GroupNorm(8), relu | RB(64) | conv k3 s2 64->128
          | RB(128) | RB(128) | CA(128) | proj 1x1 128->D

The strided conv pads one voxel on every side (upstream's padding=1), so
8^3 becomes 4^3 for both kernels. A residual block is
x + 0.1 * conv2(relu(gn2(conv1(relu(gn1(x)))))) with GroupNorm(8), channel
attention x * sigmoid(relu(mean(x) @ fc1) @ fc2), as in `layers.py`; the
nearest codeword of each of the 64 latent rows is its index, and the
decoder is `layers.Layers.decode`.

Departures from upstream: the weights are read from this repo's `.vqmodel`
artifact (JAX layout, turned to OIDHW) and not from a torch state_dict; the
channel attention's linears carry no bias, as the artifacts hold none; the
nearest code is the argmin of |e|^2 - 2 z.e (upstream's distance adds
|z|^2, the same for every code, so the argmin is the same). Nothing is
folded: the strided conv runs as it is, where the program runs it on the
packed grid.

`sizes` reads the architecture's sizes from an artifact's weight shapes,
`encoder_flops` counts its encoder as `counts/flops.py` counts the decoder.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.counts import flops
from portbench.reference import layers
from portbench.reference.layers import exact_f32


def _blocks(enc: Dict) -> List[str]:
    """The residual blocks on the 4^3 grid: rb (scalar) or rb1, rb2 (vec3)."""
    return [k for k in ("rb", "rb1", "rb2") if k in enc]


def sizes(params: Dict, config: Dict) -> Dict:
    """The decoder's sizes and the encoder's: the 8^3 stage's width
    (`pre_width`), the strided conv's kernel (`down_kernel`), the 4^3
    stage's width `encoder_width` (the projection's input, which the program
    folds into the score matrix) and its residual blocks (`encoder_blocks`)."""
    enc = params["encoder"]
    return dict(flops.decoder_sizes(params, config),
                pre_width=int(enc["pre_conv"]["w"].shape[-1]),
                down_kernel=int(enc["down"]["w"].shape[0]),
                encoder_width=int(enc["down"]["w"].shape[-1]),
                encoder_blocks=len(_blocks(enc)))


def encoder_flops(s: Dict) -> int:
    """The 8^3 stage (conv k3 C->P and RB(P) over 512 voxels), the strided
    conv P->W over the 64 latent positions, RB(W) x `encoder_blocks`,
    channel attention, proj 1x1 W->D, the distances."""
    v, p = flops.LEAF_VOXELS, flops.LATENT_POSITIONS
    pre, w = s["pre_width"], s["encoder_width"]
    return (flops.conv(v, 3, s["in_channels"], pre) + 2 * flops.conv(v, 3, pre, pre)
            + flops.conv(p, s["down_kernel"], pre, w)
            + s["encoder_blocks"] * 2 * flops.conv(p, 3, w, w)
            + flops.attention(w, s["attention_reduction"])
            + flops.conv(p, 1, w, s["embedding_dim"])
            + flops.distances(s))


class Model(layers.Model):
    """The strided-conv model of one artifact."""

    ARCHS = ("reference",)

    def latent(self, leaves: torch.Tensor) -> torch.Tensor:
        enc, lay = self.p["encoder"], self.layers
        groups = 4 if self.channels == 1 else 8
        with exact_f32():
            x = leaves.to(torch.float32).permute(0, 4, 1, 2, 3)
            h = torch.relu(lay.gn(enc["pre_gn"], lay.conv(enc["pre_conv"], x), groups))
            h = lay.residual_block(enc["pre_rb"], h)
            h = lay.conv(enc["down"], h, stride=2, padding=1)
            for name in _blocks(enc):
                h = lay.residual_block(enc[name], h)
            z = lay.conv(enc["proj"], lay.attention(enc["attn"], h))
        return z.permute(0, 2, 3, 4, 1).reshape(-1, z.shape[1])
