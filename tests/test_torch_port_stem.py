"""The packed_stem encoder and the folded final conv in the port, against the
JAX package on the CPU in f32.

packed_stem (`models/vqvae.py`): an 8^3 stage (k3 conv C -> W/8, GroupNorm
of W/16 groups, relu) before the space-to-channel pack, then a k1 stem conv.
`fold_final_conv` (`ops/subpixel.py`): the decoder's final k3 conv folded
before the pixel shuffle, which the codecs decode through with
`fuse_decoder_tail=False`. Models are JAX-initialised and carried across
with `params_from_jax`. Tolerances: features and leaves within 1e-5 (f32
sums in another order); gradients within 2e-5 of the tree's largest entry
(tests/test_torch_port_train.py); indices equal except where the JAX scores'
best two are within 1e-5 relative, and files equal byte for byte on equal
indices; the folded weights within 1e-6 of JAX's (both fold in f64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core import artifact as jartifact
from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models import blocks as jblocks
from vqvdb_tpu.models import vqvae as jvqvae
from vqvdb_tpu.ops.subpixel import fold_final_conv as jax_fold_final_conv
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.train import train as jtrain
from vqvdb_tpu_torch.cli import main as cli
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_from_jax, params_to_jax
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.models import blocks, vqvae
from vqvdb_tpu_torch.models.quantizer import VQState
from vqvdb_tpu_torch.ops.subpixel import fold_final_conv, shuffle_channels_to_space
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.train import train
from vqvdb_tpu_torch.vdb.grid import LeafGrid

torch.set_num_threads(2)

ATOL = 1e-5
NEAR_TIE = 1e-5
STEM = dict(embedding_dim=16, num_embeddings=32, encoder_arch="packed_stem")


def _models(kw, seed=3):
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = jax.jit(jvqvae.init_vqvae_params, static_argnums=1)(jax.random.key(seed), jcfg)
    tree = jax.tree.map(np.asarray, jp._asdict())
    return jp, jcfg, tree, cfg


def _leaves(rng, n, channels=1):
    x = rng.random((n, 8, 8, 8, channels), np.float32)
    return x * 2 - 1 if channels == 3 else x


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        v = v._asdict() if hasattr(v, "_asdict") else v
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("channels", [1, 3], ids=["scalar", "vec3"])
def test_packed_stem_forward_matches_jax(rng, channels):
    """As tests/test_encoder_v2.py:236: the graph's shapes and its encoder
    outputs, and the port's own init draws the JAX package's tree."""
    kw = dict(STEM, in_channels=channels)
    jp, jcfg, tree, cfg = _models(kw)
    w = vqvae.packed_encoder_width(cfg)
    assert tree["encoder"]["pre_conv"]["w"].shape == (3, 3, 3, channels, w // 8)
    assert tree["encoder"]["stem_conv"]["w"].shape == (1, 1, 1, w, w)
    mine = vqvae.init_vqvae_params(torch.Generator().manual_seed(0), cfg)
    # (jax.tree.map sorts a dict's keys; init_vqvae_params keeps JAX's order)
    assert list(mine["encoder"]) == list(vqvae.encoder_keys(cfg))
    assert sorted(mine["encoder"]) == sorted(tree["encoder"])
    assert {k: v.shape for k, v in _flat(params_to_jax(mine)).items()} == \
        {k: v.shape for k, v in _flat(tree).items()}
    params = params_from_jax(tree, cfg, "cpu")
    x = _leaves(rng, 5, channels)
    got = vqvae.encoder_apply(params["encoder"], torch.from_numpy(x), cfg)
    want = jvqvae.encoder_apply(jp.encoder, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    idx = vqvae.encode_to_indices(params, torch.from_numpy(x), cfg)
    assert idx.shape == (5, 4, 4, 4)


def test_packed_stem_gradients_after_one_step():
    jp, jcfg, tree, cfg = _models(STEM)
    batch = _leaves(np.random.default_rng(1), 8)
    tj = jtrain.TrainConfig(compute_dtype="float32")
    tp = train.TrainConfig(compute_dtype="float32")
    loss_fn = jax.jit(jax.value_and_grad(
        lambda t, vq, b: jtrain._forward_loss(t, vq, b, jcfg, tj, None), has_aux=True))
    (jloss, (_, jm, _)), jg = loss_fn((jp.encoder, jp.decoder), jp.vq, jnp.asarray(batch))
    params = params_from_jax(tree, cfg, "cpu")
    trainable = train.tree_map(lambda t: t.detach().requires_grad_(),
                               {"encoder": params["encoder"], "decoder": params["decoder"]})
    loss, (_, m, _) = train._forward_loss(trainable, VQState(**params["vq"]),
                                          torch.from_numpy(batch), cfg, tp)
    grads = torch.autograd.grad(loss, train.tree_leaves(trainable))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for key in jm:
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    got = _flat(params_to_jax(train.tree_unflatten(trainable, grads)))
    want = _flat(jax.tree.map(np.asarray, {"encoder": jg[0], "decoder": jg[1]}))
    assert got.keys() == want.keys() and "encoder/pre_conv/w" in got
    scale = max(float(np.abs(g).max()) for g in want.values())
    for key, w in want.items():
        assert np.abs(got[key] - w).max() <= 2e-5 * scale, key


def _indices(path):
    with VqvdbReader(path) as r:
        return r.read_grid()[1]


@pytest.mark.parametrize("fuse_proj", [True, False])
def test_packed_stem_codecs_match_jax(rng, tmp_path, fuse_proj):
    """A JAX-initialised packed_stem model through both codecs: indices equal
    off near-ties, the files equal but for those rows' index bytes, and each
    package's decode of the JAX file within 1e-5."""
    kw = dict(STEM, embedding_dim=32, num_embeddings=64)
    jp, jcfg, tree, cfg = _models(kw, seed=4)
    opts = dict(batch_size=16, compute_dtype="float32", fuse_proj_quantize=fuse_proj)
    codec = VQCodec(tree, cfg, CodecConfig(**opts), device="cpu")
    jcodec = JaxCodec(jp, jcfg, JaxCodecConfig(**opts))
    n = 37
    origins = (np.stack(np.unravel_index(np.arange(n), (8, 8, 8)), 1) * 8).astype(np.int32)
    grid = LeafGrid("density", origins, _leaves(rng, n))
    from vqvdb_tpu.vdb.grid import LeafGrid as JaxLeafGrid

    codec.compress(grid, tmp_path / "ours.vqvdb")
    jcodec.compress(JaxLeafGrid("density", origins, grid.leaves), tmp_path / "theirs.vqvdb")
    got, want = _indices(tmp_path / "ours.vqvdb").reshape(-1), \
        _indices(tmp_path / "theirs.vqvdb").reshape(-1)
    z = np.asarray(jvqvae.encoder_apply(jp.encoder, jnp.asarray(grid.leaves), jcfg))
    z = z.reshape(-1, 32).astype(np.float64)
    e = np.asarray(jp.vq.embedding, np.float64)
    two = np.sort((e * e).sum(1)[None] - 2 * z @ e.T, axis=1)[:, :2]
    ties = (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))
    bad = got != want
    assert not (bad & ~ties).any()
    a = np.frombuffer((tmp_path / "ours.vqvdb").read_bytes(), np.uint8)
    b = np.frombuffer((tmp_path / "theirs.vqvdb").read_bytes(), np.uint8)
    assert a.shape == b.shape and (a != b).sum() == bad.sum()
    mine, _ = codec.decompress(tmp_path / "theirs.vqvdb")
    ref, _ = jcodec.decompress(tmp_path / "theirs.vqvdb")
    np.testing.assert_allclose(mine[0].leaves, ref[0].leaves, atol=ATOL)


def test_cli_trains_and_exports_packed_stem_for_jax(tmp_path, capsys, monkeypatch):
    """`train --encoder-arch packed_stem` and `export-checkpoint` of its
    checkpoint: the .vqmodel loads in the JAX package, leaf for leaf, and
    the JAX codec encodes with it."""
    monkeypatch.setattr(jartifact, "init_vqvae_params",
                        jax.jit(jartifact.init_vqvae_params, static_argnums=1))
    np.save(tmp_path / "a.npy", np.random.default_rng(0).random((40, 8, 8, 8), np.float32))
    flags = ["--embedding-dim", "16", "--num-embeddings", "32", "--encoder-arch",
             "packed_stem", "--device", "cpu"]
    model = tmp_path / "out" / "m.vqmodel"
    assert cli(["train", "--data-dir", str(tmp_path), "--model-path", str(model),
                "--epochs", "1", "--batch-size", "16", "--compute-dtype", "float32",
                *flags]) == 0
    exported = tmp_path / "exported.vqmodel"
    assert cli(["export-checkpoint", str(tmp_path / "out" / "ckpts"), str(exported),
                "--best", *flags]) == 0
    capsys.readouterr()
    for path in (model, exported):
        jparams, jcfg = jartifact.load_model(path)
        assert jcfg.encoder_arch == "packed_stem"
        from vqvdb_tpu_torch.core.artifact import load_model

        tree, cfg = load_model(path)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        want = _flat(tree)
        got = _flat(jax.tree.map(np.asarray, jparams._asdict()))
        assert got.keys() == want.keys() and "encoder/pre_gn/scale" in got
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert model.read_bytes() == exported.read_bytes()  # both the best-val state
    leaves = _leaves(np.random.default_rng(2), 4)
    assert np.asarray(JaxCodec(jparams, jcfg, JaxCodecConfig(batch_size=4)).encode_leaves(
        leaves)).shape == (4, 4, 4, 4)


@pytest.mark.parametrize("cout", [1, 3])
def test_fold_final_conv_matches_jax(rng, cout):
    """As tests/test_subpixel.py: the folded weights equal JAX's, and
    shuffle(conv'(h)) equals conv(shuffle(h)) on random data, every border."""
    w = rng.standard_normal((3, 3, 3, 32, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal(cout).astype(np.float32)
    mine, theirs = fold_final_conv(w, b), jax_fold_final_conv(w, b)
    np.testing.assert_allclose(mine["w"].permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(theirs["w"]), atol=1e-6)
    np.testing.assert_array_equal(mine["b"].numpy(), np.asarray(theirs["b"]))
    h = rng.standard_normal((3, 4, 4, 4, 256)).astype(np.float32)
    conv = {"w": torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()), "b": torch.from_numpy(b)}
    ref = blocks.conv3d(conv, blocks.pixel_shuffle_3d(torch.from_numpy(h), 2), padding=1)
    got = shuffle_channels_to_space(blocks.conv3d(mine, torch.from_numpy(h), padding=1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    jgot = jblocks.pixel_shuffle_3d(jblocks.conv3d(theirs, jnp.asarray(h), padding=1), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="k3"):
        fold_final_conv(np.zeros((1, 1, 1, 32, 1), np.float32), np.zeros(1, np.float32))


@pytest.mark.parametrize("kw", [dict(embedding_dim=32, num_embeddings=64, encoder_arch="packed"),
                                dict(in_channels=3, embedding_dim=32, num_embeddings=64,
                                     encoder_arch="packed_stem")],
                         ids=["scalar", "vec3_stem"])
@pytest.mark.parametrize("fold", [True, False], ids=["folded_final", "three_ops"])
def test_unfused_tail_decode_matches_jax(rng, tmp_path, kw, fold):
    """fuse_decoder_tail=False, with the final conv folded (the default) or
    not: the port's decode within 1e-5 of the JAX codec's on the same
    indices, and the dense decode the sparse one's bit for bit."""
    from vqvdb_tpu_torch.runtime.dense import decode_to_dense

    jp, jcfg, tree, cfg = _models(kw, seed=6)
    opts = dict(batch_size=16, compute_dtype="float32", fuse_decoder_tail=False,
                fuse_final_conv=fold)
    codec = VQCodec(tree, cfg, CodecConfig(**opts), device="cpu")
    jcodec = JaxCodec(jp, jcfg, JaxCodecConfig(**opts))
    assert (codec._folded_final is not None) == fold and codec._folded_tail is None
    idx = rng.integers(0, 64, (21, 4, 4, 4)).astype(np.uint8)
    got = codec.decode_indices(idx)
    np.testing.assert_allclose(got, np.asarray(jcodec.decode_indices(idx)), atol=ATOL)
    tail = VQCodec(tree, cfg, CodecConfig(batch_size=16, compute_dtype="float32"),
                   device="cpu")
    np.testing.assert_allclose(got, tail.decode_indices(idx), atol=ATOL)
    origins = (np.stack(np.unravel_index(np.arange(21), (3, 7, 1)), 1) * 8).astype(np.int32)
    dense, _ = decode_to_dense(codec, idx, origins)
    host, _ = LeafGrid("d", origins, got).to_dense()
    np.testing.assert_array_equal(dense.numpy(), host)
