"""Plain layers of the VQ-VAE on NCDHW float32 tensors, its decoder, and
what every plain model shares (`Model`: the decode, the nearest code).

Each product (a conv or a matrix product) takes its operands through
`self.round`, which is the identity for the reference. The control
replaces it with a lower precision (`fp8`): every operand of every product
rounded to float8 e4m3 under a per-tensor scale, the products summed in
float32, which is what a float8 path of the program would compute.

The decoder (both variants):
    conv k3 D->W, GroupNorm(8), relu | residual blocks | channel attention
    | up_conv k3 W->256 | voxel shuffle x2 (channel = oc*8 + rd*4 + rh*2 + rw)
    | conv k3 32->C | sigmoid (C = 1) or tanh (C = 3)
with residual block x + 0.1 * conv2(relu(gn2(conv1(relu(gn1(x)))))) and
channel attention x * sigmoid(relu(mean(x) @ fc1) @ fc2).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = (t.abs().amax() / FP8_MAX).clamp(min=1e-30)
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDINGS: Dict[str, Optional[Callable]] = {"float32": None, "fp8": fp8}


@contextlib.contextmanager
def exact_f32():
    """TF32 off in cuBLAS and cuDNN, restored after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = old


def to_torch(tree, device: torch.device):
    """A JAX-layout params tree of numpy arrays -> float32 tensors; convs
    (5-D, DHWIO) to OIDHW."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    t = torch.from_numpy(np.asarray(tree, np.float32).copy()).to(device)
    return t.permute(4, 3, 0, 1, 2).contiguous() if t.dim() == 5 else t


class Layers:
    """The plain layers; `rounding` names an entry of ROUNDINGS."""

    def __init__(self, rounding: str = "float32"):
        self.rounding = rounding
        fn = ROUNDINGS[rounding]
        self.round = fn if fn is not None else (lambda t: t)

    def conv(self, p: Dict, x: torch.Tensor, stride: int = 1,
             padding: Optional[int] = None) -> torch.Tensor:
        """A conv of stride `stride`; SAME padding of its odd kernel unless
        `padding` is given."""
        w = p["w"]
        pad = w.shape[-1] // 2 if padding is None else padding
        return F.conv3d(self.round(x), self.round(w), p.get("b"), stride=stride, padding=pad)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    @staticmethod
    def gn(p: Dict, x: torch.Tensor, groups: int) -> torch.Tensor:
        return F.group_norm(x, groups, p["scale"], p["bias"], eps=1e-5)

    def residual_block(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(p["conv1"], torch.relu(self.gn(p["gn1"], x, 8)))
        h = self.conv(p["conv2"], torch.relu(self.gn(p["gn2"], h, 8)))
        return x + 0.1 * h

    def attention(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.matmul(x.mean(dim=(2, 3, 4)), p["fc1"]["w"]))
        y = torch.sigmoid(self.matmul(y, p["fc2"]["w"]))
        return x * y[:, :, None, None, None]

    def trunk(self, p: Dict, h: torch.Tensor, blocks) -> torch.Tensor:
        """GroupNorm(8) and relu after a stem conv, the residual blocks, the
        channel attention."""
        h = torch.relu(self.gn(p["stem_gn"], h, 8))
        for name in blocks:
            h = self.residual_block(p[name], h)
        return self.attention(p["attn"], h)

    def decode(self, dec: Dict, z: torch.Tensor, channels: int) -> torch.Tensor:
        """Codewords z [B, 4, 4, 4, D] -> leaves [B, 8, 8, 8, C]."""
        blocks = [k for k in ("rb", "rb1", "rb2") if k in dec]
        h = self.conv(dec["stem_conv"], z.permute(0, 4, 1, 2, 3))
        h = self.conv(dec["up_conv"], self.trunk(dec, h, blocks))
        b, c, d, hh, w = h.shape
        h = h.reshape(b, c // 8, 2, 2, 2, d, hh, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
        h = self.conv(dec["final"], h.reshape(b, c // 8, 2 * d, 2 * hh, 2 * w))
        h = torch.sigmoid(h) if channels == 1 else torch.tanh(h)
        return h.permute(0, 2, 3, 4, 1)

    def nearest(self, z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
        """Index of the nearest codeword of each row of z [N, D]: the argmin
        of |e|^2 - 2 z.e over the codebook [K, D] (|z|^2 is the same for
        every code)."""
        scores = (codebook * codebook).sum(dim=1) - 2.0 * self.matmul(z, codebook.T)
        return torch.argmin(scores, dim=1)


class Model:
    """The plain model of one single-stage artifact on `device`, computed in
    float32 with TF32 off (or in the control's rounding). A subclass names
    the `encoder_arch`s it computes (`ARCHS`) and gives `latent`, its
    encoder up to the latent rows."""

    ARCHS: Tuple[str, ...] = ()

    def __init__(self, params: Dict, config: Dict, device: torch.device,
                 rounding: str = "float32"):
        if config["encoder_arch"] not in self.ARCHS or config.get("num_quantizers", 1) != 1:
            raise ValueError(f"not a single-stage {'/'.join(self.ARCHS)} model: {config}")
        self.channels = config["in_channels"]
        self.p = to_torch(params, device)
        self.codebook = self.p["vq"]["embedding"]
        self.layers = Layers(rounding)

    def latent(self, leaves: torch.Tensor) -> torch.Tensor:
        """Leaves [B, 8, 8, 8, C] -> latent rows [B * 64, D] in (d, h, w) order."""
        raise NotImplementedError

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
