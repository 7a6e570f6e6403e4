"""Every other committed artifact through the port's codec against the JAX
package's, on the CPU in f32 (the flagship is in test_torch_port_codec.py).

Both codecs get the same batch and dtype, and the JAX codec `fuse_rb16=True`
as well: the port's codec always fuses the reference scalar encoder's
16-channel block, and so the JAX side runs its Pallas residual-block kernel
in interpret mode. The `.vqvdb` v3 files must be byte-identical except for
index bytes of near-tie rows: latent rows whose best and runner-up JAX
scores differ by less than NEAR_TIE relative to the best (for residual-VQ,
at the first stage where the row differs; its later stages then code
another residual). Each package reads the other's file, and on the same
indices the decoded leaves agree within 1e-5.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.artifact import load_model as jax_load_model
from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.models import quantizer as jquantizer
from vqvdb_tpu.models import vqvae as jvqvae
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.vdb.grid import LeafGrid as JaxLeafGrid
from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.models.vqvae import (
    encoder_apply,
    encoder_features,
    encoder_features_packed_down,
)
from vqvdb_tpu_torch.ops.quantize import fused_nearest_indices, fused_score_argmin
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.vdb.grid import LeafGrid, psnr

torch.set_num_threads(2)

MODELS = Path(__file__).parent.parent / "models"
NEAR_TIE = 1e-5
ATOL = 1e-5
BATCH = 24
# round-trip PSNR floors on the small test field, well under what each
# artifact reaches there
MIN_PSNR = {"scalar_reference": 30.0, "scalar_rvq2": 30.0,
            "scalar_packed_lite": 30.0, "vec3": 20.0, "vec3_rvq2": 20.0}


def smooth_field(channels, seed=0, shape=(32, 32, 24), blobs=4):
    """Gaussian blobs thresholded to a sparse field: [0, 1] density for one
    channel, a [-1, 1] vector field (blob x direction) for three."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[tuple(slice(0, s) for s in shape)].astype(np.float32)
    dense = np.zeros(shape + (channels,), np.float32)
    for _ in range(blobs):
        c = rng.uniform(0, np.array(shape), 3)
        s = rng.uniform(3, 8)
        blob = np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / (2 * s * s))
        direction = np.ones(1) if channels == 1 else rng.uniform(-1, 1, channels)
        dense += blob[..., None] * direction.astype(np.float32)
    dense[np.abs(dense).max(-1) < 0.05] = 0
    dense = np.clip(dense, 0 if channels == 1 else -1, 1)
    return dense[..., 0] if channels == 1 else dense


def _indices(path):
    with VqvdbReader(path) as r:
        return r.read_grid()[1]


def _near_ties(scores):
    two = np.sort(scores, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))


def _stage_scores(jcodec, jparams, jcfg, leaves, ref_idx):
    """The JAX-side scores that decided each stage of `ref_idx` [N, S]."""
    x = jnp.asarray(leaves)
    if jcodec._score_mc is not None:
        if jcodec._folded_down is not None:
            h = jvqvae.encoder_features_packed_down(
                jparams.encoder, jcodec._folded_down, x, jcfg,
                fuse_rb16=jcodec.ccfg.fuse_rb16 and jcfg.variant == "scalar")
        else:
            h = jvqvae.encoder_features(jparams.encoder, x, jcfg)
        m, c = jcodec._score_mc
        return [np.asarray(h).reshape(-1, h.shape[-1]) @ np.asarray(m) + np.asarray(c)]
    res = jvqvae.encoder_apply(jparams.encoder, x, jcfg).reshape(-1, jcfg.embedding_dim)
    out = []
    for s in range(jcfg.num_quantizers):
        e = jparams.vq.embedding[s]
        out.append(np.asarray(jnp.sum(e * e, axis=1)[None] - 2.0 * res @ e.T))
        res = res - jquantizer.dequantize(jnp.asarray(ref_idx[:, s].astype(np.int32)), e)
    return out


@pytest.mark.parametrize("name", ["scalar_reference", "scalar_rvq2", "vec3",
                                  "vec3_rvq2", "scalar_packed_lite"])
def test_artifact_compress_decompress_matches_jax(tmp_path, name):
    tree, cfg = load_model(MODELS / f"{name}.vqmodel")
    jparams, jcfg = jax_load_model(MODELS / f"{name}.vqmodel")
    opts = dict(batch_size=BATCH, compute_dtype="float32")
    codec = VQCodec(tree, cfg, CodecConfig(**opts), device="cpu")
    jcodec = JaxCodec(jparams, jcfg, JaxCodecConfig(**opts, fuse_rb16=True))
    assert codec.check_latent_shape() == cfg.index_shape == tuple(jcfg.index_shape)
    dense = smooth_field(cfg.in_channels)
    grid, jgrid = LeafGrid.from_dense("field", dense), JaxLeafGrid.from_dense("field", dense)
    assert grid.num_leaves > BATCH  # a full batch and a ragged tail
    ours, theirs = tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb"
    stats = codec.compress(grid, ours)
    jcodec.compress(jgrid, theirs)
    assert stats["leaves"] == grid.num_leaves and not stats["aborted"]

    s = cfg.num_quantizers
    got, ref = _indices(ours), _indices(theirs)
    assert got.shape == ref.shape == (grid.num_leaves,) + cfg.index_shape
    got, ref = got.reshape(-1, s), ref.reshape(-1, s)
    alive = np.ones(got.shape[0], bool)
    for stage, scores in enumerate(_stage_scores(jcodec, jparams, jcfg, grid.leaves, ref)):
        bad = alive & (got[:, stage] != ref[:, stage])
        off = bad & ~_near_ties(scores)
        assert not off.any(), f"stage {stage}: {int(off.sum())} rows differ off near-ties"
        alive &= ~bad
    # The files differ in those index bytes and nowhere else.
    a, b = (np.frombuffer(p.read_bytes(), np.uint8) for p in (ours, theirs))
    assert a.shape == b.shape
    assert (a != b).sum() == (got != ref).sum()
    print(f"{name}: {int((~alive).sum())} of {got.shape[0]} rows differ")

    # Each package decodes both files; on the same indices the leaves agree.
    mine, _ = codec.decompress(theirs)
    want, _ = jcodec.decompress(theirs)
    np.testing.assert_array_equal(mine[0].origins, want[0].origins)
    np.testing.assert_allclose(mine[0].leaves, want[0].leaves, atol=ATOL)
    theirs_of_ours, _ = jcodec.decompress(ours)
    mine_of_ours, _ = codec.decompress(ours)
    np.testing.assert_allclose(mine_of_ours[0].leaves, theirs_of_ours[0].leaves, atol=ATOL)
    assert psnr(mine_of_ours[0].leaves, grid.leaves) > MIN_PSNR[name]


def test_reference_arch_options_agree():
    """The codec's encode of the reference artifact (the strided conv folded
    onto the packed grid, the fused 16-channel block, the projection folded
    into the score kernel) against each rewrite undone at function level:
    the eager block, the strided conv as it is (`encoder_features`), and the
    projection then the nearest-code kernel. Every one gives the same
    indices except near-ties of the codec's scores."""
    tree, cfg = load_model(MODELS / "scalar_reference.vqmodel")
    leaves = LeafGrid.from_dense("d", smooth_field(1, seed=2, shape=(24, 24, 16))).leaves
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=16, compute_dtype="float32"),
                    device="cpu")
    assert codec._folded_down is not None
    ref = codec.encode_leaves(leaves).reshape(-1)
    enc, x = codec.params["encoder"], torch.from_numpy(leaves)
    with torch.inference_mode():
        feats = encoder_features_packed_down(enc, codec._folded_down, x, cfg, fuse_rb16=True)
        m, c = codec._score_mc
        ties = _near_ties((feats.reshape(-1, 32) @ m + c).numpy())
        undone = {
            "eager_rb16": encoder_features_packed_down(enc, codec._folded_down, x, cfg,
                                                       fuse_rb16=False),
            "strided_conv": encoder_features(enc, x, cfg),
        }
        got = {k: fused_score_argmin(h.reshape(-1, 32), codec._score_prep)
               for k, h in undone.items()}
        z = encoder_apply(enc, x, cfg).reshape(-1, cfg.embedding_dim).float()
        got["nearest_code"] = fused_nearest_indices(z, codec.params["vq"]["embedding"])
    for name, idx in got.items():
        assert not ((idx.numpy() != ref) & ~ties).any(), name
