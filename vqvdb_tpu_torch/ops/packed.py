"""Space-to-channel packing and the strided-conv fold (counterpart of
`vqvdb_tpu/ops/packed.py`).

Channel convention: packed index = c_orig * 8 + parity, where parity =
a*4 + b*2 + c for voxel offset (a,b,c) — the channel split of
`blocks.pixel_shuffle_3d`, so the two are mutual inverses.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch


def space_to_channel(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/r, H/r, W/r, C*r^3)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // r, r, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, d // r, h // r, w // r, c * r**3)


def fold_strided_conv(w, b, r: int = 2) -> Dict[str, torch.Tensor]:
    """Fold a stride-2, padding-1 conv (kernel k in {3, 4}) on the fine grid
    into a k3 SAME conv on the packed coarse grid with unpacked output.

    w: JAX-layout (k, k, k, Cin, Cout), b: (Cout,). Returns the port's conv
    params on the CPU: {'w': (Cout, Cin*8, 3, 3, 3) f32 channels-last, 'b'}.

    Per axis, output cell p reads fine voxels 2p + d - 1 for d in [0, k).
    Writing 2p + d - 1 = 2(p + e) + s gives d = 2e + s + 1, so the taps are
    e in {-1, 0, 1} with d in [0, k): a k3 SAME conv on the packed grid
    covers every case, and zero padding on the fine grid maps to zero
    padding of the packed grid. The sums are taken in f64.
    """
    w = np.asarray(w, np.float64)
    k, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    r3 = r**3
    out = np.zeros((3, 3, 3, cin * r3, cout), np.float64)
    for sp in itertools.product(range(r), repeat=3):
        p_idx = (sp[0] * r + sp[1]) * r + sp[2]
        for e in itertools.product((-1, 0, 1), repeat=3):
            d = tuple(r * e[a] + sp[a] + 1 for a in range(3))
            if all(0 <= da < k for da in d):
                out[e[0] + 1, e[1] + 1, e[2] + 1, p_idx::r3, :] += \
                    w[d[0], d[1], d[2]]
    folded = torch.from_numpy(out.astype(np.float32)).permute(4, 3, 0, 1, 2)
    return {"w": folded.contiguous(memory_format=torch.channels_last_3d),
            "b": torch.from_numpy(np.array(b, dtype=np.float32))}
