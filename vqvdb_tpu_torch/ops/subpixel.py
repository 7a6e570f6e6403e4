"""Subpixel folding of the decoder's final conv (counterpart of
`vqvdb_tpu/ops/subpixel.py`).

The decoder tail is up_conv (4^3, 256) -> pixel shuffle -> final k3 conv
(8^3, 32 -> C), with no nonlinearity between the shuffle and the final
conv. So conv(shuffle(x)) equals shuffle(conv'(x)) for a k3 SAME conv' on
the pre-shuffle grid: for shuffle rate r = 2, output parity s reads tap
d = 2e + s' - s (valid when |d| <= 1) from cell offset e and input parity
s'. Zero padding on the 8^3 grid maps onto zero padding on the 4^3 grid,
so the identity is exact up to the order of the f32 sums. The codec
decodes through it when `fuse_decoder_tail` is off and `fuse_final_conv`
on (`CodecConfig`), as the JAX codec does.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch

from vqvdb_tpu_torch.models.blocks import pixel_shuffle_3d


def fold_final_conv(w_final: np.ndarray, b_final: np.ndarray, r: int = 2
                    ) -> Dict[str, torch.Tensor]:
    """Fold a k3 post-shuffle conv into a k3 pre-shuffle conv.

    w_final: (3,3,3, C_in, C_out) DHWIO weights of the post-shuffle conv (the
    JAX layout, as a `.vqmodel` stores them). Returns {'w': OIDHW
    (C_out r^3, C_in r^3, 3,3,3) f32 channels-last, 'b': (C_out r^3,) f32} on
    the CPU, folded in f64 as the JAX package folds. Channels are ordered
    (oc, parity d, h, w) with oc outermost, as `pixel_shuffle_3d` splits them.
    """
    w = np.asarray(w_final, np.float64)
    kd, kh, kw, cin, cout = w.shape
    if (kd, kh, kw) != (3, 3, 3):
        raise ValueError(f"fold_final_conv expects a k3 conv, got {(kd, kh, kw)}")
    r3 = r ** 3
    out = np.zeros((3, 3, 3, cin * r3, cout * r3), np.float64)
    parities = list(itertools.product(range(r), repeat=3))
    for s in parities:  # output parity
        for sp in parities:  # input parity
            for e in itertools.product((-1, 0, 1), repeat=3):  # cell offset
                d = tuple(r * e[a] + sp[a] - s[a] for a in range(3))
                if all(-1 <= da <= 1 for da in d):
                    m_idx = (s[0] * r + s[1]) * r + s[2]
                    p_idx = (sp[0] * r + sp[1]) * r + sp[2]
                    out[e[0] + 1, e[1] + 1, e[2] + 1, p_idx::r3, m_idx::r3] += \
                        w[d[0] + 1, d[1] + 1, d[2] + 1]
    b = np.repeat(np.asarray(b_final, np.float64)[:, None], r3, axis=1).reshape(-1)
    w_oidhw = torch.from_numpy(out.astype(np.float32).transpose(4, 3, 0, 1, 2).copy())
    return {"w": w_oidhw.contiguous(memory_format=torch.channels_last_3d),
            "b": torch.from_numpy(b.astype(np.float32))}


def shuffle_channels_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, D, H, W, C r^3) -> (B, D r, H r, W r, C): `pixel_shuffle_3d`."""
    return pixel_shuffle_3d(x, r)
