"""The codec's one inference path per model against the plain graph, for
every committed artifact in `models/`, on the CPU in f32.

The codec's steps run exact rewrites of the model: the decoder tail folded
into one GEMM, the 1x1 projection folded into the score kernel, a reference
encoder's strided conv folded onto the packed grid and its scalar 16-channel
residual block fused. The plain graph runs none of them:
`vqvae.encode_to_indices` (the encoder as written, then the nearest-code
kernel) and `decoder_tail(decoder_pre_tail(...))` of the dequantized rows.
Indices must be equal except on near-tie rows, whose best and runner-up
plain f32 scores differ by less than NEAR_TIE relative to the best (for
residual-VQ at the first stage where a row differs; its later stages then
code another residual). Decoded leaves must agree within ATOL.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.models import vqvae
from vqvdb_tpu_torch.models.quantizer import dequantize, nearest_scores
from vqvdb_tpu_torch.runtime.codec import VQCodec

torch.set_num_threads(2)

MODELS = Path(__file__).parent.parent / "models"
ARTIFACTS = sorted(p.stem for p in MODELS.glob("*.vqmodel"))
NEAR_TIE = 1e-5  # relative best-vs-runner-up score gap
ATOL = 1e-5
LEAVES = 5


@pytest.fixture(scope="module", params=ARTIFACTS)
def codec(request):
    tree, cfg = load_model(MODELS / f"{request.param}.vqmodel")
    return VQCodec(tree, cfg, CodecConfig(batch_size=LEAVES, compute_dtype="float32"),
                   device="cpu")


def _leaves(cfg, seed=0):
    x = np.random.default_rng(seed).random((LEAVES, 8, 8, 8, cfg.in_channels), np.float32)
    return torch.from_numpy(x * 2 - 1 if cfg.in_channels == 3 else x)


def _near_ties(scores):
    two = torch.sort(scores, dim=1).values[:, :2]
    return (two[:, 1] - two[:, 0]) < NEAR_TIE * torch.clamp(two[:, 0].abs(), min=1.0)


def test_artifacts_are_all_here():
    assert len(ARTIFACTS) == 7, ARTIFACTS


@pytest.mark.parametrize("step", ["encode", "decode"])
def test_codec_steps_equal_the_plain_graph(codec, step):
    cfg, p = codec.mcfg, codec.params
    s = cfg.num_quantizers
    with torch.inference_mode():
        if step == "decode":
            idx = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.num_embeddings, (LEAVES,) + cfg.index_shape)).to(torch.int32)
            books = p["vq"]["embedding"].reshape(s, cfg.num_embeddings, cfg.embedding_dim)
            flat = idx.reshape(-1, s)
            z = sum(dequantize(flat[:, j], books[j]) for j in range(s))
            z = z.reshape((LEAVES,) + cfg.latent_shape + (cfg.embedding_dim,))
            dec = p["decoder"]
            want = vqvae.decoder_tail(dec, vqvae.decoder_pre_tail(dec, z, cfg), cfg)
            got = codec._decode_step(idx)
            assert got.shape == want.shape == (LEAVES, 8, 8, 8, cfg.in_channels)
            torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
            return
        x = _leaves(cfg)
        got = codec._encode_step(x).to(torch.int64).reshape(-1, s)
        want = vqvae.encode_to_indices(p, x, cfg).to(torch.int64).reshape(-1, s)
        res = vqvae.encoder_apply(p["encoder"], x, cfg).reshape(-1, cfg.embedding_dim)
        books = p["vq"]["embedding"].reshape(s, cfg.num_embeddings, cfg.embedding_dim)
    alive = torch.ones(got.shape[0], dtype=torch.bool)
    for j in range(s):
        bad = alive & (got[:, j] != want[:, j])
        off = bad & ~_near_ties(nearest_scores(res, books[j]))
        assert not off.any(), f"stage {j}: {int(off.sum())} rows differ off near-ties"
        alive &= ~bad
        res = res - books[j][want[:, j]]
    assert int(alive.sum()) >= got.shape[0] // 2  # near-ties are rare
