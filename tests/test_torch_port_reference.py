"""The reference-arch encoders, the vec3 graphs, the strided-conv fold,
residual-VQ and the wider score-argmin shapes against the JAX package, on
the CPU in f32.

Tolerances: the fold 1e-6 (f64 sums rounded to f32 on both sides); the
folded conv against the strided conv rtol = atol = 1e-5 (f32 sums in
another order); whole graphs atol 5e-5; the vec3 tail operator atol 1e-5.
Residual-VQ indices must be equal stage by stage, except that a row may
differ at its first differing stage s only if the JAX scores of that stage
(on the residual both packages share up to there) have a best-vs-runner-up
gap under NEAR_TIE relative; its later stages then code another residual
and are not compared.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.artifact import load_model as jax_load_model
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models import blocks as jblocks
from vqvdb_tpu.models import quantizer as jquantizer
from vqvdb_tpu.models import vqvae as jvqvae
from vqvdb_tpu.ops import packed as jpacked
from vqvdb_tpu.ops import quantize as jq
from vqvdb_tpu.ops.tail import apply_decoder_tail as jax_apply_tail
from vqvdb_tpu.ops.tail import fold_decoder_tail as jax_fold_tail
from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.weights import params_from_jax, tree_to_torch
from vqvdb_tpu_torch.models import blocks, vqvae
from vqvdb_tpu_torch.models.quantizer import rvq_dequantize, rvq_indices
from vqvdb_tpu_torch.ops import quantize as q
from vqvdb_tpu_torch.ops.packed import fold_strided_conv, space_to_channel
from vqvdb_tpu_torch.ops.tail import apply_decoder_tail, fold_decoder_tail
from vqvdb_tpu_torch.utils.errors import ConfigError

torch.set_num_threads(2)

MODELS = Path(__file__).parent.parent / "models"
NEAR_TIE = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# fold_strided_conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,cin,cout", [(4, 16, 32), (3, 32, 48)])
def test_fold_strided_conv(rng, k, cin, cout):
    w, b = _rand(rng, k, k, k, cin, cout, scale=0.1), _rand(rng, cout)
    ref = jpacked.fold_strided_conv(w, b)
    got = fold_strided_conv(w, b)
    assert got["w"].shape == (cout, cin * 8, 3, 3, 3)
    # the port's OIDHW against the JAX DHWIO
    np.testing.assert_allclose(got["w"].permute(2, 3, 4, 1, 0).numpy(),
                               _np(ref["w"]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["b"].numpy(), _np(ref["b"]))
    # the identity: the folded k3 conv on the packed grid is the strided conv
    x = _rand(rng, 3, 8, 8, 8, cin)
    strided = blocks.conv3d(tree_to_torch({"w": w, "b": b}, torch.device("cpu")),
                            torch.from_numpy(x), stride=2, padding=1)
    folded = blocks.conv3d(got, space_to_channel(torch.from_numpy(x), 2), padding=1)
    assert folded.shape == (3, 4, 4, 4, cout)
    np.testing.assert_allclose(folded.numpy(), strided.numpy(), rtol=1e-5, atol=1e-5)
    jstrided = jblocks.conv3d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              jnp.asarray(x), stride=2, padding=1)
    np.testing.assert_allclose(strided.numpy(), _np(jstrided), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _narrow(arch, in_channels):
    """A random-init model at narrow quantizer widths (D=32, K=64)."""
    kw = dict(in_channels=in_channels, embedding_dim=32, num_embeddings=64,
              encoder_arch=arch)
    jcfg = JaxModelConfig(**kw)
    jparams = jvqvae.init_vqvae_params(jax.random.key(5), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    cfg = ModelConfig(**kw)
    return jparams, jcfg, cfg, params_from_jax(tree, cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _artifact(name):
    jparams, jcfg = jax_load_model(MODELS / f"{name}.vqmodel")
    tree, cfg = load_model(MODELS / f"{name}.vqmodel")
    return jparams, jcfg, cfg, params_from_jax(tree, cfg, device="cpu")


def _model(source, in_channels):
    if source == "narrow":
        return _narrow("reference", in_channels)
    return _artifact(source)


@pytest.mark.parametrize("source,in_channels", [
    ("narrow", 1), ("narrow", 3), ("scalar_reference", 1), ("scalar_rvq2", 1)])
def test_reference_encoder_graphs(rng, source, in_channels):
    """encoder_apply (strided conv) and encoder_features_packed_down, with
    and without the fused block, against the JAX functions."""
    jparams, jcfg, cfg, p = _model(source, in_channels)
    x = rng.random((3, 8, 8, 8, in_channels), dtype=np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ref = jvqvae.encoder_apply(jparams.encoder, xj, jcfg)
    got = vqvae.encoder_apply(p["encoder"], xt, cfg)
    assert got.shape == (3, 4, 4, 4, cfg.embedding_dim)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5)

    down = jparams.encoder["down"]
    jfolded = jpacked.fold_strided_conv(np.asarray(down["w"]), np.asarray(down["b"]))
    folded = fold_strided_conv(np.asarray(down["w"]), np.asarray(down["b"]))
    for fuse in (False, True):
        # The JAX side runs its Pallas kernel (interpret mode) when fused.
        ref = jvqvae.encoder_features_packed_down(
            jparams.encoder, jfolded, xj, jcfg,
            fuse_rb16=fuse and in_channels == 1)
        got = vqvae.encoder_features_packed_down(p["encoder"], folded, xt, cfg,
                                                 fuse_rb16=fuse)
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5)
        plain = vqvae.encoder_features(p["encoder"], xt, cfg)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=5e-5)


@pytest.mark.parametrize("source", ["narrow", "vec3", "vec3_rvq2"])
def test_vec3_encoder_decoder_and_tail(rng, source):
    if source == "narrow":
        jparams, jcfg, cfg, p = _narrow("packed", 3)
    else:
        jparams, jcfg, cfg, p = _artifact(source)
    x = (2 * rng.random((2, 8, 8, 8, 3), dtype=np.float32) - 1)
    ref = jvqvae.encoder_apply(jparams.encoder, jnp.asarray(x), jcfg)
    got = vqvae.encoder_apply(p["encoder"], torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5)
    z = _rand(rng, 2, 4, 4, 4, cfg.embedding_dim, scale=0.5)
    ref = jvqvae.decoder_apply(jparams.decoder, jnp.asarray(z), jcfg)
    got = vqvae.decoder_apply(p["decoder"], torch.from_numpy(z), cfg)
    assert got.shape == (2, 8, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5)
    # the folded tail: an 8192 -> 1536 operator, then tanh
    jfold = jax_fold_tail(jparams.decoder, jcfg)
    fold = fold_decoder_tail(p["decoder"], cfg)
    assert fold["k"].shape == (8192, 1536) and fold["b"].shape == (1536,)
    np.testing.assert_allclose(fold["k"].numpy(), _np(jfold["k"]), atol=1e-5)
    np.testing.assert_allclose(fold["b"].numpy(), _np(jfold["b"]), atol=1e-5)
    h = _rand(rng, 2, 4, 4, 4, 128, scale=0.5)
    ref = jax_apply_tail(jfold, jnp.asarray(h), jcfg)
    got = apply_decoder_tail(fold, torch.from_numpy(h), cfg)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5)
    np.testing.assert_allclose(
        got.numpy(), vqvae.decoder_tail(p["decoder"], torch.from_numpy(h), cfg).numpy(),
        atol=5e-5)


def test_packed_stem_still_raises():
    cfg = ModelConfig(encoder_arch="packed_stem")
    with pytest.raises(ConfigError):
        vqvae.check_ported(cfg)
    with pytest.raises(ConfigError):
        vqvae.encoder_features({}, torch.zeros(1, 8, 8, 8, 1), cfg)
    for name in ("scalar", "scalar_packed_lite", "scalar_reference", "scalar_rvq2",
                 "vec3", "vec3_rvq2"):
        vqvae.check_ported(load_model(MODELS / f"{name}.vqmodel")[1])


def test_rvq_codebook_shape_is_checked():
    tree, cfg = load_model(MODELS / "scalar_rvq2.vqmodel")
    assert params_from_jax(tree, cfg, device="cpu")["vq"]["embedding"].shape == (2, 256, 128)
    flagship = load_model(MODELS / "scalar_reference.vqmodel")[1]
    with pytest.raises(ConfigError):  # [2, K, D] codebooks under a 1-stage config
        params_from_jax(tree, flagship, device="cpu")


# ---------------------------------------------------------------------------
# Residual VQ
# ---------------------------------------------------------------------------

def _jax_stage_scores(z, state, ref_idx):
    """Per stage: the JAX-side scores on the JAX residual, [S][N, K]."""
    res = jnp.asarray(z)
    out = []
    for s in range(state.embedding.shape[0]):
        e = state.embedding[s]
        out.append(np.asarray(jnp.sum(e * e, axis=1)[None] - 2.0 * res @ e.T))
        res = res - jquantizer.dequantize(jnp.asarray(ref_idx[:, s]), e)
    return out


def assert_rvq_indices_match(got, ref, stage_scores):
    """The per-stage near-tie rule of the module docstring. Returns the
    number of rows that differ."""
    alive = np.ones(got.shape[0], bool)
    for s, scores in enumerate(stage_scores):
        bad = alive & (got[:, s] != ref[:, s])
        two = np.sort(scores, axis=1)[:, :2]
        ties = (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))
        assert not (bad & ~ties).any(), (
            f"stage {s}: {int((bad & ~ties).sum())} rows differ off near-ties")
        alive &= ~bad
    return int((~alive).sum())


@pytest.mark.parametrize("name", ["scalar_rvq2", "vec3_rvq2"])
def test_rvq_indices_and_dequantize(rng, name):
    jparams, jcfg, cfg, p = _artifact(name)
    x = rng.random((4, 8, 8, 8, cfg.in_channels), dtype=np.float32)
    z = np.array(jvqvae.encoder_apply(jparams.encoder, jnp.asarray(x), jcfg)
                 ).reshape(-1, cfg.embedding_dim)
    ref = np.asarray(jquantizer.rvq_indices(jnp.asarray(z), jparams.vq))
    got = rvq_indices(torch.from_numpy(z), p["vq"]["embedding"])
    assert got.shape == ref.shape == (256, 2) and got.dtype == torch.int32
    differ = assert_rvq_indices_match(got.numpy(), ref,
                                      _jax_stage_scores(z, jparams.vq, ref))
    print(f"{name}: {differ} of {ref.shape[0]} rows differ")
    # decode: the same indices give the same sum of rows, bit for bit
    idx = rng.integers(0, 256, size=(300, 2))
    want = np.asarray(jquantizer.rvq_dequantize(jnp.asarray(idx), jparams.vq))
    rows = rvq_dequantize(torch.from_numpy(idx.astype(np.uint8)), p["vq"]["embedding"])
    np.testing.assert_array_equal(rows.numpy(), want)


def test_rvq_exact_ties_and_out_of_range(rng):
    """Integer-valued codebooks with duplicate rows: every stage ties
    exactly and takes the first code; an out-of-range index adds a zero
    row in decode."""
    s, k, d = 3, 64, 16
    cb = rng.integers(-2, 3, size=(s, k, d)).astype(np.float32)
    cb[:, 50] = cb[:, 3]
    z = rng.integers(-4, 5, size=(200, d)).astype(np.float32)
    z[0] = cb[0, 3] + cb[1, 3] + cb[2, 3]
    state = jquantizer.VQState(jnp.asarray(cb), jnp.zeros((s, k)), jnp.asarray(cb))
    ref = np.asarray(jquantizer.rvq_indices(jnp.asarray(z), state))
    got = rvq_indices(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not (got == 50).any()
    idx = rng.integers(0, k, size=(100, s))
    idx[[0, 5], [0, 2]] = [200, k]
    want = np.asarray(jquantizer.rvq_dequantize(jnp.asarray(idx), state))
    rows = rvq_dequantize(torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(cb))
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(rows[0].numpy(), cb[1, idx[0, 1]] + cb[2, idx[0, 2]])


# ---------------------------------------------------------------------------
# Score-argmin at the reference arch's (32) and vec3's (128) feature widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f", [32, 128])
def test_score_argmin_widths_match_pallas(rng, f):
    n, k = 1000, 256
    h = rng.integers(-3, 4, size=(n, f)).astype(np.float32)
    m = rng.integers(-3, 4, size=(f, k)).astype(np.float32)
    c = rng.integers(-40, 40, size=(1, k)).astype(np.float32)
    m[:, 200] = m[:, 9]
    c[0, 9] = c[0, 200] = -10000.0  # columns 9 and 200 tie and win every row
    ref = np.asarray(jq.fused_score_argmin(jnp.asarray(h), jnp.asarray(m),
                                           jnp.asarray(c), tile_n=256, interpret=True))
    got = q.fused_score_argmin(torch.from_numpy(h), torch.from_numpy(m),
                               torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 9).all()
    h2, m2, c2 = _rand(rng, n, f), _rand(rng, f, k), _rand(rng, 1, k)
    ref = np.asarray(jq.fused_score_argmin(jnp.asarray(h2), jnp.asarray(m2),
                                           jnp.asarray(c2), tile_n=256, interpret=True))
    got = q.score_argmin_plain(torch.from_numpy(h2), torch.from_numpy(m2),
                               torch.from_numpy(c2)).numpy()
    np.testing.assert_array_equal(got, ref)
