"""The port's blocks, graphs and folds against the JAX package, in f32.

The same numpy-seeded inputs and weights go through each JAX function and
its counterpart. Tolerances: single ops rtol 1e-5 + atol 1e-5 (f32 conv
sums of up to 1,728 terms, taken in another order); whole graphs atol 5e-5;
the tail operator atol 1e-5; the projection fold exact (f64 on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models import blocks as jblocks
from vqvdb_tpu.models import vqvae as jvqvae
from vqvdb_tpu.ops import packed as jpacked
from vqvdb_tpu.ops.quantize import fold_proj_into_scores as jax_fold_proj
from vqvdb_tpu.ops.tail import fold_decoder_tail as jax_fold_tail
from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.weights import params_from_jax, tree_to_torch
from vqvdb_tpu_torch.models import blocks, vqvae
from vqvdb_tpu_torch.ops.packed import space_to_channel
from vqvdb_tpu_torch.ops.quantize import fold_proj_into_scores
from vqvdb_tpu_torch.ops.tail import fold_decoder_tail

torch.set_num_threads(2)

ATOL = 1e-5
RTOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _port(tree):
    """A JAX-layout numpy tree as the port's CPU tensors."""
    return tree_to_torch(tree, torch.device("cpu"))


@pytest.mark.parametrize("k,pad,cin,cout", [(3, 1, 8, 16), (1, 0, 16, 24),
                                            (3, 1, 64, 32)])
def test_conv3d(rng, k, pad, cin, cout):
    x = _rand(rng, 2, 4, 4, 4, cin)
    p = {"w": _rand(rng, k, k, k, cin, cout, scale=0.1), "b": _rand(rng, cout)}
    ref = jblocks.conv3d({k_: jnp.asarray(v) for k_, v in p.items()},
                         jnp.asarray(x), padding=pad)
    got = blocks.conv3d(_port(p), torch.from_numpy(x), padding=pad)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("groups", [4, 8])
def test_group_norm(rng, groups):
    x = _rand(rng, 3, 4, 4, 4, 16, scale=3.0) + 1.0
    p = {"scale": _rand(rng, 16), "bias": _rand(rng, 16)}
    ref = jblocks.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), groups)
    got = blocks.group_norm(_port(p), torch.from_numpy(x), groups)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_pixel_shuffle_and_space_to_channel(rng):
    x = _rand(rng, 2, 4, 4, 4, 16)
    ref = jblocks.pixel_shuffle_3d(jnp.asarray(x), 2)
    got = blocks.pixel_shuffle_3d(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    y = _rand(rng, 2, 8, 8, 8, 3)
    ref = jpacked.space_to_channel(jnp.asarray(y), 2)
    got = space_to_channel(torch.from_numpy(y), 2)
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    # mutual inverses, as in the JAX package
    np.testing.assert_array_equal(
        blocks.pixel_shuffle_3d(got, 2).numpy(), y)


def _rb_params(rng, c, k2):
    return {
        "gn1": {"scale": 1 + _rand(rng, c, scale=0.1), "bias": _rand(rng, c, scale=0.1)},
        "conv1": {"w": _rand(rng, 3, 3, 3, c, c, scale=0.05), "b": _rand(rng, c, scale=0.1)},
        "gn2": {"scale": 1 + _rand(rng, c, scale=0.1), "bias": _rand(rng, c, scale=0.1)},
        "conv2": {"w": _rand(rng, k2, k2, k2, c, c, scale=0.05), "b": _rand(rng, c, scale=0.1)},
    }


@pytest.mark.parametrize("k2", [3, 1])
def test_residual_block(rng, k2):
    x = _rand(rng, 2, 4, 4, 4, 16)
    p = _rb_params(rng, 16, k2)
    ref = jblocks.residual_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = blocks.residual_block(_port(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_channel_attention(rng):
    x = _rand(rng, 3, 4, 4, 4, 16)
    p = {"fc1": {"w": _rand(rng, 16, 4)}, "fc2": {"w": _rand(rng, 4, 16)}}
    ref = jblocks.channel_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = blocks.channel_attention(_port(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _narrow(arch):
    """A random-init scalar model of `arch` at narrow widths (D=32, K=64)."""
    jcfg = JaxModelConfig(embedding_dim=32, num_embeddings=64, encoder_arch=arch)
    jparams = jvqvae.init_vqvae_params(jax.random.key(3), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    cfg = ModelConfig(embedding_dim=32, num_embeddings=64, encoder_arch=arch)
    return jparams, jcfg, tree, cfg, params_from_jax(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def narrow_model():
    return _narrow("packed")


@pytest.mark.parametrize("arch", ["packed", "packed_lite"])
def test_encoder_and_decoder_graphs(rng, arch):
    jparams, jcfg, _, cfg, p = _narrow(arch)
    x = rng.random((3, 8, 8, 8, 1), dtype=np.float32)
    ref = jvqvae.encoder_apply(jparams.encoder, jnp.asarray(x), jcfg)
    got = vqvae.encoder_apply(p["encoder"], torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5)
    z = _rand(rng, 3, 4, 4, 4, 32)
    ref = jvqvae.decoder_apply(jparams.decoder, jnp.asarray(z), jcfg)
    got = vqvae.decoder_apply(p["decoder"], torch.from_numpy(z), cfg)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5)


def test_fold_decoder_tail_matches_jax(narrow_model):
    jparams, jcfg, _, cfg, p = narrow_model
    ref = jax_fold_tail(jparams.decoder, jcfg)
    got = fold_decoder_tail(p["decoder"], cfg)
    assert got["k"].shape == (4096, 512) and got["b"].shape == (512,)
    np.testing.assert_allclose(got["k"].numpy(), _np(ref["k"]), atol=ATOL)
    np.testing.assert_allclose(got["b"].numpy(), _np(ref["b"]), atol=ATOL)


def test_fold_proj_into_scores_matches_jax(narrow_model):
    _, _, tree, _, _ = narrow_model
    proj, emb = tree["encoder"]["proj"], tree["vq"].embedding
    rm, rc = jax_fold_proj(proj["w"], proj["b"], emb)
    m, c = fold_proj_into_scores(proj["w"], proj["b"], emb)
    np.testing.assert_array_equal(m.numpy(), _np(rm))
    np.testing.assert_array_equal(c.numpy(), _np(rc))
