"""Plain reference of the packed VQ-VAE (`encoder_arch` "packed" and
"packed_lite"), scalar and vec3.

Encoder: the 8^3 leaf packed 2x2x2 into channels (4^3 grid, 8C channels,
channel = c*8 + a*4 + b*2 + e for the voxel offset (a, b, e)) | conv k3
8C->W, GroupNorm(8), relu | residual block | channel attention | proj 1x1
W->D, with W = 64 (C = 1) or 128 (C = 3). The nearest codeword of each of
the 64 latent rows is its index. The decoder is `layers.Layers.decode`.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.layers import Layers, exact_f32, to_torch

ARCHS = ("packed", "packed_lite")


class Model:
    """The model of one artifact on `device`, computed in float32 with TF32
    off (or in the control's rounding)."""

    def __init__(self, params: Dict, config: Dict, device: torch.device,
                 rounding: str = "float32"):
        if config["encoder_arch"] not in ARCHS or config.get("num_quantizers", 1) != 1:
            raise ValueError(f"not a packed single-stage model: {config}")
        self.channels = config["in_channels"]
        self.p = to_torch(params, device)
        self.codebook = self.p["vq"]["embedding"]
        self.layers = Layers(rounding)

    @staticmethod
    def pack(x: torch.Tensor) -> torch.Tensor:
        """[B, 8, 8, 8, C] -> [B, 8C, 4, 4, 4]."""
        b, c = x.shape[0], x.shape[-1]
        x = x.reshape(b, 4, 2, 4, 2, 4, 2, c).permute(0, 7, 2, 4, 6, 1, 3, 5)
        return x.reshape(b, 8 * c, 4, 4, 4)

    def latent(self, leaves: torch.Tensor) -> torch.Tensor:
        """Leaves [B, 8, 8, 8, C] -> latent rows [B * 64, D] in (d, h, w) order."""
        enc, lay = self.p["encoder"], self.layers
        with exact_f32():
            h = lay.conv(enc["stem_conv"], self.pack(leaves.to(torch.float32)))
            z = lay.conv(enc["proj"], lay.trunk(enc, h, ["rb"]))
        return z.permute(0, 2, 3, 4, 1).reshape(-1, z.shape[1])

    def encode(self, leaves: torch.Tensor) -> torch.Tensor:
        """Leaves [B, 8, 8, 8, C] -> indices [B, 4, 4, 4] (int64)."""
        with exact_f32():
            idx = self.layers.nearest(self.latent(leaves), self.codebook)
        return idx.reshape(-1, 4, 4, 4)

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices [B, 4, 4, 4] -> leaves [B, 8, 8, 8, C] float32."""
        with exact_f32():
            z = self.codebook[indices.long()]
            return self.layers.decode(self.p["decoder"], z, self.channels)
