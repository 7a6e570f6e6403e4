"""Space-to-channel packing (counterpart of `vqvdb_tpu/ops/packed.py`).

Channel convention: packed index = c_orig * 8 + parity, where parity =
a*4 + b*2 + c for voxel offset (a,b,c) — the channel split of
`blocks.pixel_shuffle_3d`, so the two are mutual inverses.
"""

from __future__ import annotations

import torch


def space_to_channel(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/r, H/r, W/r, C*r^3)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // r, r, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, d // r, h // r, w // r, c * r**3)
