"""Plain reference of the packed VQ-VAE (`encoder_arch` "packed" and
"packed_lite"), scalar and vec3.

Encoder: the 8^3 leaf packed 2x2x2 into channels (4^3 grid, 8C channels,
channel = c*8 + a*4 + b*2 + e for the voxel offset (a, b, e)) | conv k3
8C->W, GroupNorm(8), relu | residual block | channel attention | proj 1x1
W->D, with W = 64 (C = 1) or 128 (C = 3). The nearest codeword of each of
the 64 latent rows is its index. The decoder is `layers.Layers.decode`.

`sizes` reads the architecture's sizes from an artifact's weight shapes,
`encoder_flops` counts its encoder as `counts/flops.py` counts the decoder.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.counts import flops
from portbench.reference import layers
from portbench.reference.layers import exact_f32


def sizes(params: Dict, config: Dict) -> Dict:
    """The decoder's sizes, the packed encoder's width W (`encoder_width`, the
    projection's input, which the program folds into the score matrix) and
    the residual block's closer kernel (3 packed, 1 packed_lite)."""
    enc = params["encoder"]
    return dict(flops.decoder_sizes(params, config),
                encoder_width=int(enc["stem_conv"]["w"].shape[-1]),
                closer_kernel=int(enc["rb"]["conv2"]["w"].shape[0]))


def encoder_flops(s: Dict) -> int:
    """Stem conv k3 8C->W, the residual block's k3 and closer convs, channel
    attention, proj 1x1 W->D, the distances."""
    p, w = flops.LATENT_POSITIONS, s["encoder_width"]
    return (flops.conv(p, 3, 8 * s["in_channels"], w)
            + flops.conv(p, 3, w, w) + flops.conv(p, s["closer_kernel"], w, w)
            + flops.attention(w, s["attention_reduction"])
            + flops.conv(p, 1, w, s["embedding_dim"])
            + flops.distances(s))


class Model(layers.Model):
    """The packed model of one artifact."""

    ARCHS = ("packed", "packed_lite")

    @staticmethod
    def pack(x: torch.Tensor) -> torch.Tensor:
        """[B, 8, 8, 8, C] -> [B, 8C, 4, 4, 4]."""
        b, c = x.shape[0], x.shape[-1]
        x = x.reshape(b, 4, 2, 4, 2, 4, 2, c).permute(0, 7, 2, 4, 6, 1, 3, 5)
        return x.reshape(b, 8 * c, 4, 4, 4)

    def latent(self, leaves: torch.Tensor) -> torch.Tensor:
        enc, lay = self.p["encoder"], self.layers
        with exact_f32():
            h = lay.conv(enc["stem_conv"], self.pack(leaves.to(torch.float32)))
            z = lay.conv(enc["proj"], lay.trunk(enc, h, ["rb"]))
        return z.permute(0, 2, 3, 4, 1).reshape(-1, z.shape[1])
