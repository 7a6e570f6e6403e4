"""The port's codec against the JAX package's, on the CPU in f32.

The flagship artifact (`models/scalar.vqmodel`, packed scalar, K=256,
D=128) runs at full width on a small smooth field. Files must be byte-equal
except on near-tie rows: latent rows whose best and runner-up JAX scores
differ by less than NEAR_TIE relative to the best. The flagship codebook
holds such pairs (codes 29 and 238 are nearly the same vector), and there
the two packages' f32 sums, taken in another order, may pick either code.
Decoded leaves must agree within 1e-5 (sigmoid outputs in [0, 1]).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.artifact import load_model as jax_load_model
from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models.vqvae import encoder_apply as jax_encoder_apply
from vqvdb_tpu.models.vqvae import encoder_features as jax_encoder_features
from vqvdb_tpu.models.vqvae import init_vqvae_params
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.vdb.grid import LeafGrid as JaxLeafGrid
from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.utils.errors import ConfigError
from vqvdb_tpu_torch.vdb.grid import LeafGrid, psnr

torch.set_num_threads(2)

FLAGSHIP = Path(__file__).parent.parent / "models" / "scalar.vqmodel"
NEAR_TIE = 1e-5  # relative best-vs-runner-up score gap
ATOL = 1e-5
BATCH = 24


def smooth_field(seed=0, shape=(32, 32, 24), blobs=4):
    """Gaussian blobs in [0, 1], thresholded to a sparse level of detail."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[tuple(slice(0, s) for s in shape)].astype(np.float32)
    dense = np.zeros(shape, np.float32)
    for _ in range(blobs):
        c = rng.uniform(0, np.array(shape), 3)
        s = rng.uniform(3, 8)
        dense += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / (2 * s * s))
    dense[dense < 0.05] = 0
    return np.clip(dense, 0, 1)


def _indices(path):
    with VqvdbReader(path) as r:
        return r.read_grid()[1]


def _near_ties(scores):
    """Rows of [N, K] scores whose two best differ by < NEAR_TIE relative."""
    part = np.sort(scores, axis=1)[:, :2]
    return (part[:, 1] - part[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(part[:, 0]))


def _assert_indices_match(got, ref, scores):
    got, ref = got.reshape(-1), ref.reshape(-1)
    bad = got != ref
    ties = _near_ties(scores)
    assert not (bad & ~ties).any(), f"{int((bad & ~ties).sum())} rows differ off near-ties"
    return int(bad.sum()), int(ties.sum())


@pytest.fixture(scope="module")
def flagship():
    tree, cfg = load_model(FLAGSHIP)
    jparams, jcfg = jax_load_model(FLAGSHIP)
    dense = smooth_field()
    return tree, cfg, jparams, jcfg, dense


@pytest.mark.parametrize("fuse_proj", [True, False])
def test_flagship_compress_decompress_matches_jax(tmp_path, flagship, fuse_proj):
    tree, cfg, jparams, jcfg, dense = flagship
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=BATCH, compute_dtype="float32",
                                           fuse_proj_quantize=fuse_proj),
                    device="cpu")
    jcodec = JaxCodec(jparams, jcfg, JaxCodecConfig(
        batch_size=BATCH, compute_dtype="float32", fuse_proj_quantize=fuse_proj))
    grid, jgrid = LeafGrid.from_dense("density", dense), JaxLeafGrid.from_dense("density", dense)
    assert grid.num_leaves > BATCH  # a full batch and a ragged tail
    ours, theirs = tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb"
    stats = codec.compress(grid, ours)
    jcodec.compress(jgrid, theirs)
    assert stats["leaves"] == grid.num_leaves and not stats["aborted"]

    # The files differ only in index bytes of near-tie rows.
    a, b = np.frombuffer(ours.read_bytes(), np.uint8), np.frombuffer(theirs.read_bytes(), np.uint8)
    assert a.shape == b.shape
    x = jnp.asarray(grid.leaves)
    if fuse_proj:
        h = np.asarray(jax_encoder_features(jparams.encoder, x, jcfg)).reshape(-1, 64)
        m, c = jcodec._score_mc
        scores = h @ np.asarray(m) + np.asarray(c)
    else:
        z = np.asarray(jax_encoder_apply(jparams.encoder, x, jcfg)).reshape(-1, 128)
        e = np.asarray(jparams.vq.embedding)
        scores = (e * e).sum(1)[None] - 2 * z @ e.T
    differ, ties = _assert_indices_match(_indices(ours), _indices(theirs), scores)
    assert (a != b).sum() == differ
    print(f"fuse_proj={fuse_proj}: {differ} of {scores.shape[0]} rows differ, "
          f"{ties} near-tie rows")

    # Each package decodes both files; on the same indices the leaves agree.
    got, _ = codec.decompress(theirs)
    ref, _ = jcodec.decompress(theirs)
    np.testing.assert_array_equal(got[0].origins, ref[0].origins)
    np.testing.assert_allclose(got[0].leaves, ref[0].leaves, atol=ATOL)
    ref_ours, _ = jcodec.decompress(ours)
    assert ref_ours[0].num_leaves == grid.num_leaves
    assert psnr(got[0].leaves, grid.leaves) > 30.0


def test_narrow_random_model_matches_jax(rng):
    """A random-init narrow config (D=32, K=64) through params_from_jax,
    with the unfused decoder tail as well."""
    jcfg = JaxModelConfig(embedding_dim=32, num_embeddings=64, encoder_arch="packed")
    jparams = init_vqvae_params(jax.random.key(7), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    cfg = ModelConfig(embedding_dim=32, num_embeddings=64, encoder_arch="packed")
    leaves = LeafGrid.from_dense("d", smooth_field(seed=1, shape=(24, 24, 16))).leaves
    idx = rng.integers(0, 64, size=(leaves.shape[0], 4, 4, 4), dtype=np.uint8)
    for fuse_tail in (True, False):
        codec = VQCodec(tree, cfg, CodecConfig(batch_size=16, compute_dtype="float32",
                                               fuse_decoder_tail=fuse_tail),
                        device="cpu")
        jcodec = JaxCodec(jparams, jcfg, JaxCodecConfig(
            batch_size=16, compute_dtype="float32", fuse_decoder_tail=fuse_tail))
        np.testing.assert_allclose(codec.decode_indices(idx),
                                   np.asarray(jcodec.decode_indices(idx)), atol=ATOL)
    got = codec.encode_leaves(leaves)
    ref = np.asarray(jcodec.encode_leaves(leaves))
    h = np.asarray(jax_encoder_features(jparams.encoder, jnp.asarray(leaves), jcfg))
    m, c = jcodec._score_mc
    _assert_indices_match(got, ref, h.reshape(-1, 64) @ np.asarray(m) + np.asarray(c))
    assert codec.check_latent_shape() == (4, 4, 4)


def test_device_rule_and_unported_configs():
    tree, cfg = load_model(FLAGSHIP)
    if torch.cuda.is_available():
        pytest.skip("the no-card rule needs a host without CUDA")
    with pytest.raises(ConfigError):
        VQCodec(tree, cfg)
    with pytest.raises(ConfigError):
        VQCodec(tree, cfg, device="cuda")
    # packed_stem is the one encoder left to port; a model whose codebook
    # does not fit its config is refused as well.
    with pytest.raises(ConfigError):
        VQCodec(tree, ModelConfig(encoder_arch="packed_stem"), device="cpu")
    with pytest.raises(ConfigError):
        VQCodec(tree, ModelConfig(num_quantizers=2, encoder_arch="packed"), device="cpu")


def test_compress_abort_keeps_a_valid_file(tmp_path, flagship):
    """should_stop between batches: the written batches stay decodable and
    the grid's block count is patched, readable by both packages."""
    tree, cfg, jparams, jcfg, dense = flagship
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=BATCH, compute_dtype="float32"),
                    device="cpu")
    grid = LeafGrid.from_dense("density", dense)
    calls = []
    stats = codec.compress(grid, tmp_path / "a.vqvdb",
                           should_stop=lambda: calls.append(1) or len(calls) > 1)
    assert stats["aborted"] and stats["leaves"] == BATCH
    out, _ = codec.decompress(tmp_path / "a.vqvdb")
    assert out[0].num_leaves == BATCH
    np.testing.assert_array_equal(out[0].origins, grid.origins[:BATCH])
    ref, _ = JaxCodec(jparams, jcfg, JaxCodecConfig(
        batch_size=BATCH, compute_dtype="float32")).decompress(tmp_path / "a.vqvdb")
    np.testing.assert_allclose(out[0].leaves, ref[0].leaves, atol=ATOL)
