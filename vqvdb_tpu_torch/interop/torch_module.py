"""Inference-only torch mirror of the VQ-VAE, for deployment interop (the
port's own copy of `vqvdb_tpu/interop/torch_module.py`, same module tree).

Models trained in either package must be consumable by the reference
ecosystem: its ONNX conversion entry point loads a TorchScript module exposing
`encode` / `decode` (ref: python/to_onnx.py:46-56, torch.jit.load) and its
training checkpoints are torch state_dicts keyed by the reference module
tree (ref: python/training.py:219-233). This module defines a minimal,
inference-only torch VQVAE whose state_dict keys match that tree exactly
(the same key layout core/torch_import.py consumes), so that

  * `interop.export_state_dict(params, cfg)` loads into it verbatim, and
  * `torch.jit.script`-ing it yields a `.pt` the reference's to_onnx.py
    accepts unmodified.

The graph is built from our own architecture documentation
(models/vqvae.py module docstring; numerics held to the JAX package's
forward in tests/test_torch_port_interop.py) — it is a re-statement of the
published architecture (ref: python/VQVAE_v2.py:231-377), not a copy of reference
code: no training paths, no loss, no EMA, TorchScript-friendly shapes only.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqvdb_tpu_torch.core.config import ModelConfig


class _ResidualBlock(nn.Module):
    """Pre-activation GN residual block, scaled residual (scale=0.1)."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.gn1 = nn.GroupNorm(groups, channels)
        self.conv1 = nn.Conv3d(channels, channels, 3, 1, 1, bias=True)
        self.gn2 = nn.GroupNorm(groups, channels)
        self.conv2 = nn.Conv3d(channels, channels, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.gn1(x)))
        h = self.conv2(F.relu(self.gn2(h)))
        return x + 0.1 * h


class _ChannelAttention(nn.Module):
    """Squeeze-excite gate: spatial mean -> fc -> sigmoid -> scale."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3, 4))
        y = torch.sigmoid(self.fc(y))
        return x * y[:, :, None, None, None]


class _PixelShuffle3D(nn.Module):
    """Voxel shuffle with (oc, rd, rh, rw) channel split, oc outermost —
    the ordering our blocks.pixel_shuffle_3d and ported weights assume."""

    def __init__(self, r: int = 2):
        super().__init__()
        self.r = r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d, h, w = x.shape
        r = self.r
        oc = c // (r * r * r)
        x = x.view(b, oc, r, r, r, d, h, w)
        x = x.permute(0, 1, 5, 2, 6, 3, 7, 4).contiguous()
        return x.view(b, oc, d * r, h * r, w * r)


class _EncoderScalar(nn.Module):
    def __init__(self, in_channels: int, embedding_dim: int):
        super().__init__()
        self.pre = nn.Sequential(
            nn.Conv3d(in_channels, 16, 3, 1, 1, bias=True),
            nn.GroupNorm(4, 16),
            nn.ReLU(),
            _ResidualBlock(16),
        )
        self.down = nn.Conv3d(16, 32, 4, 2, 1, bias=True)
        self.res_stack = nn.Sequential(_ResidualBlock(32))
        self.attn = _ChannelAttention(32)
        self.proj = nn.Conv3d(32, embedding_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.attn(self.res_stack(self.down(self.pre(x)))))


class _DecoderScalar(nn.Module):
    def __init__(self, embedding_dim: int, out_channels: int):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv3d(embedding_dim, 64, 3, 1, 1, bias=True),
            nn.GroupNorm(8, 64),
            nn.ReLU(),
        )
        self.res_stack = nn.Sequential(_ResidualBlock(64))
        self.attn = _ChannelAttention(64)
        self.up_conv = nn.Conv3d(64, 32 * 8, 3, 1, 1, bias=True)
        self.pixshuf = _PixelShuffle3D(2)
        self.final = nn.Conv3d(32, out_channels, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.res_stack(self.stem(x)))
        h = self.pixshuf(self.up_conv(h))
        return torch.sigmoid(self.final(h))


class _EncoderVec3(nn.Module):
    def __init__(self, in_channels: int, embedding_dim: int):
        super().__init__()
        self.pre = nn.Sequential(
            nn.Conv3d(in_channels, 64, 3, 1, 1, bias=True),
            nn.GroupNorm(8, 64),
            nn.ReLU(),
            _ResidualBlock(64),
        )
        self.down1 = nn.Conv3d(64, 128, 3, 2, 1, bias=True)
        self.res_stack = nn.Sequential(_ResidualBlock(128), _ResidualBlock(128))
        self.attn = _ChannelAttention(128)
        self.proj = nn.Conv3d(128, embedding_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.attn(self.res_stack(self.down1(self.pre(x)))))


class _DecoderVec3(nn.Module):
    def __init__(self, embedding_dim: int, out_channels: int):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv3d(embedding_dim, 128, 3, 1, 1, bias=True),
            nn.GroupNorm(8, 128),
            nn.ReLU(),
        )
        self.res_stack = nn.Sequential(_ResidualBlock(128), _ResidualBlock(128))
        self.attn = _ChannelAttention(128)
        self.up_conv = nn.Conv3d(128, 32 * 8, 3, 1, 1, bias=True)
        self.pixshuf = _PixelShuffle3D(2)
        self.final = nn.Conv3d(32, out_channels, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.res_stack(self.stem(x)))
        h = self.pixshuf(self.up_conv(h))
        return torch.tanh(self.final(h))


class _Quantizer(nn.Module):
    """Codebook buffers only — inference needs no EMA machinery, but the
    buffer names (embedding / cluster_size / embed_avg) must match the
    reference checkpoint layout so round-trips are lossless."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.register_buffer("embedding", torch.zeros(num_embeddings, embedding_dim))
        self.register_buffer("cluster_size", torch.zeros(num_embeddings))
        self.register_buffer("embed_avg", torch.zeros(num_embeddings, embedding_dim))


class TorchVQVAE(nn.Module):
    """Scriptable inference VQVAE with the reference's encode/decode contract:

      encode: f32 (B, C, 8, 8, 8) -> int64 indices (B, 4, 4, 4)
      decode: int64 indices (B, 4, 4, 4) -> f32 (B, C, 8, 8, 8)
    """

    def __init__(self, in_channels: int, embedding_dim: int, num_embeddings: int):
        super().__init__()
        if in_channels == 1:
            self.encoder: nn.Module = _EncoderScalar(in_channels, embedding_dim)
            self.decoder: nn.Module = _DecoderScalar(embedding_dim, in_channels)
        else:
            self.encoder = _EncoderVec3(in_channels, embedding_dim)
            self.decoder = _DecoderVec3(embedding_dim, in_channels)
        self.quantizer = _Quantizer(num_embeddings, embedding_dim)

    @torch.jit.export
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        z = self.encoder(x)
        b, dim = z.shape[0], z.shape[1]
        d, h, w = z.shape[2], z.shape[3], z.shape[4]
        flat = z.permute(0, 2, 3, 4, 1).reshape(-1, dim)
        emb = self.quantizer.embedding
        # argmin ||z - e||^2 == argmin (||e||^2 - 2 z.e); ||z||^2 is row-constant
        scores = flat @ emb.t()
        dist = (emb * emb).sum(dim=1) - 2.0 * scores
        idx = torch.argmin(dist, dim=1)
        return idx.view(b, d, h, w)

    @torch.jit.export
    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        q = F.embedding(indices, self.quantizer.embedding)
        q = q.permute(0, 4, 1, 2, 3).contiguous()
        return self.decoder(q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def build_torch_vqvae(cfg: ModelConfig) -> TorchVQVAE:
    m = TorchVQVAE(cfg.in_channels, cfg.embedding_dim, cfg.num_embeddings)
    m.eval()
    return m
