"""The port's dense paths (`vqvdb_tpu_torch/runtime/dense.py`) against the
JAX package's `runtime/dense.py` and against the port's own sparse path, on
the CPU in f32.

A random narrow packed model (the JAX package's init, the same weights in
both), at a batch of 16 so that every path runs several steps and a padded
last one; the flagship grown to K = 512 and the vec3 artifact for u16
indices and three channels. The port's dense decode must equal its sparse path
(`decode_indices` / `decompress`, then `LeafGrid.to_dense`) bit for bit,
v6 corrections included, and the JAX package's dense decode within 1e-5
(the atol of tests/test_torch_port_codec.py: sums in another order). Dense
encode must pick the active set of `LeafGrid.from_dense` in its order, give
the indices of the port's sparse encode exactly, and the JAX indices except
on near-tie rows (best and runner-up JAX scores within 1e-5 relative).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models.vqvae import encoder_features as jax_encoder_features
from vqvdb_tpu.models.vqvae import init_vqvae_params
from vqvdb_tpu.runtime import dense as jax_dense
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu_torch import api
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.runtime.dense import (
    decode_file_to_dense,
    decode_to_dense,
    encode_dense_to_file,
    encode_from_dense,
)
from vqvdb_tpu_torch.utils.errors import VqvdbError
from vqvdb_tpu_torch.vdb.grid import LeafGrid

torch.set_num_threads(2)

MODELS = Path(__file__).parent.parent / "models"
ATOL = 1e-5
NEAR_TIE = 1e-5
BATCH = 16


@pytest.fixture(scope="module")
def codecs():
    """A random narrow packed model (D=32, K=64; the JAX package's init, the
    same weights in both), f32, batch 16."""
    kw = dict(embedding_dim=32, num_embeddings=64, encoder_arch="packed")
    jcfg = JaxModelConfig(**kw)
    jparams = init_vqvae_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    opts = dict(batch_size=BATCH, compute_dtype="float32")
    return (VQCodec(tree, ModelConfig(**kw), CodecConfig(**opts), device="cpu"),
            JaxCodec(jparams, jcfg, JaxCodecConfig(**opts)), jparams)


def _sparse_grid(rng, bdims=(5, 4, 3), fill=0.4, background=0.0, channels=1):
    n_blocks = int(np.prod(bdims))
    active = rng.random(n_blocks) < fill
    active[0] = active[-1] = True  # pin both corners of the box
    (flat,) = np.nonzero(active)
    bi = np.stack(np.unravel_index(flat, bdims), axis=1)
    leaves = rng.random((flat.size, 8, 8, 8, channels), np.float32)
    return LeafGrid("density", (bi * 8).astype(np.int32), leaves, background=background)


def _sparse_dense(codec, idx, grid):
    rec = codec.decode_indices(idx)
    return LeafGrid("d", grid.origins, rec, background=grid.background).to_dense()


def test_decode_to_dense_equals_sparse_and_jax(codecs, rng):
    codec, jcodec, _ = codecs
    g = _sparse_grid(rng)
    assert g.num_leaves > BATCH  # full steps and a padded one
    idx = codec.encode_leaves(g.leaves)
    dense, lo = decode_to_dense(codec, idx, g.origins)
    assert isinstance(dense, torch.Tensor) and dense.device == codec.device
    host, hlo = _sparse_dense(codec, idx, g)
    np.testing.assert_array_equal(lo, hlo)
    np.testing.assert_array_equal(dense.numpy(), host)
    jdense, jlo = jax_dense.decode_to_dense(jcodec, idx, g.origins)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=ATOL)


def test_decode_to_dense_background_and_pinned_frame(codecs, rng):
    codec, jcodec, _ = codecs
    g = _sparse_grid(rng, bdims=(3, 3, 3), fill=0.3)
    idx = codec.encode_leaves(g.leaves)
    dense, _ = decode_to_dense(codec, idx, g.origins, background=7.5)
    jdense, _ = jax_dense.decode_to_dense(jcodec, idx, g.origins, background=7.5)
    occupied = {tuple(o // 8) for o in g.origins}
    d = dense.numpy()
    for b in np.ndindex(3, 3, 3):
        blk = d[b[0] * 8:(b[0] + 1) * 8, b[1] * 8:(b[1] + 1) * 8, b[2] * 8:(b[2] + 1) * 8]
        if b not in occupied:
            assert (blk == 7.5).all()
    np.testing.assert_allclose(d, np.asarray(jdense), atol=ATOL)
    g2 = _sparse_grid(rng, bdims=(2, 2, 2), fill=1.0)
    idx2 = codec.encode_leaves(g2.leaves)
    kw = dict(lo=(0, 0, 0), shape=(48, 48, 48))
    dense, lo = decode_to_dense(codec, idx2, g2.origins + 16, **kw)
    jdense, jlo = jax_dense.decode_to_dense(jcodec, idx2, g2.origins + 16, **kw)
    assert dense.shape == jdense.shape == (48, 48, 48, 1)
    np.testing.assert_array_equal(lo, jlo)
    assert (dense[:16] == 0).all() and (dense[16:32, 16:32, 16:32] != 0).any()
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=ATOL)


@pytest.mark.parametrize("case", ["out_of_frame", "unaligned", "unaligned_lo", "bad_shape"])
def test_decode_to_dense_rejects_as_jax(codecs, rng, case):
    codec, jcodec, _ = codecs
    g = _sparse_grid(rng, bdims=(2, 2, 2), fill=1.0)
    idx = codec.encode_leaves(g.leaves)
    args, kw = {"out_of_frame": ((g.origins,), dict(lo=(0, 0, 0), shape=(8, 8, 8))),
                "unaligned": ((g.origins + 1,), {}),
                "unaligned_lo": ((g.origins,), dict(lo=(4, 0, 0))),
                "bad_shape": ((g.origins,), dict(lo=(0, 0, 0), shape=(20, 16, 16)))}[case]
    with pytest.raises(VqvdbError) as ours:
        decode_to_dense(codec, idx, *args, **kw)
    with pytest.raises(Exception) as theirs:
        jax_dense.decode_to_dense(jcodec, idx, *args, **kw)
    assert str(ours.value) == str(theirs.value)


def test_dense_empty_as_jax(codecs):
    codec, jcodec, _ = codecs
    empty_idx, empty_org = np.zeros((0, 4, 4, 4), np.uint8), np.zeros((0, 3), np.int32)
    dense, lo = decode_to_dense(codec, empty_idx, empty_org)
    jdense, jlo = jax_dense.decode_to_dense(jcodec, empty_idx, empty_org)
    assert dense.shape == jdense.shape == (0, 0, 0, 1)
    np.testing.assert_array_equal(lo, jlo)
    idx, org = encode_from_dense(codec, np.zeros((16, 16, 16), np.float32))
    assert idx.shape == (0, 4, 4, 4) and org.shape == (0, 3) and idx.dtype == np.uint8


@pytest.mark.parametrize("mode", ["int8", "f16"])
def test_v6_dense_decode_bit_equal_to_sparse(codecs, rng, tmp_path, mode):
    """The device correction rounds as apply_residual does, so the dense
    volume of a v6 file equals decompress + to_dense bit for bit, and the
    int8 bound (max stored scale / 2) holds on it."""
    codec, jcodec, _ = codecs
    g = _sparse_grid(rng, bdims=(6, 3, 2))
    path = tmp_path / f"{mode}.vqvdb"
    codec.compress(g, path, residual=mode)
    (out,) = decode_file_to_dense(codec, path)
    grids, _ = codec.decompress(path)
    host, hlo = grids[0].to_dense()
    np.testing.assert_array_equal(out["lo"], hlo)
    np.testing.assert_array_equal(out["dense"].numpy(), host)
    src, _ = g.to_dense()
    err = np.abs(out["dense"].numpy() - src).max()
    if mode == "int8":
        from vqvdb_tpu_torch.format.vqvdb import VqvdbReader

        with VqvdbReader(path) as r:
            r.next_grid_metadata()
            scales = np.concatenate([r.next_batch_residual(64)[2] for _ in range(3)
                                     if r.has_next()])
        assert err <= scales.max() / 2
    else:
        assert err < 2e-3
    (jout,) = jax_dense.decode_file_to_dense(jcodec, path)
    np.testing.assert_allclose(out["dense"].numpy(), np.asarray(jout["dense"]), atol=ATOL)


def _jax_near_ties(jcodec, jparams, leaves):
    h = np.asarray(jax_encoder_features(jparams.encoder, jnp.asarray(leaves), jcodec.mcfg))
    m, c = jcodec._score_mc
    scores = h.reshape(-1, m.shape[0]) @ np.asarray(m) + np.asarray(c)
    two = np.sort(scores, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))


@pytest.mark.parametrize("case", ["aligned", "tolerance", "unaligned", "tensor"])
def test_encode_from_dense_equals_sparse_and_jax(codecs, rng, case):
    codec, jcodec, jparams = codecs
    kw = {}
    if case == "aligned":
        g = _sparse_grid(rng, bdims=(4, 3, 2), fill=0.5)
        dense, lo = g.to_dense()
        kw = dict(origin=lo)
    elif case == "tolerance":
        dense = np.full((24, 24, 24), 0.25, np.float32)
        dense[8:16, 8:16, 8:16] += 0.3  # one active block
        dense[0:8, 0:8, 0:8] += 1e-4  # under the tolerance
        dense[16:24, 0:8, 8:16] = rng.random((8, 8, 8))
        kw = dict(background=0.25, tolerance=1e-3)
    else:
        dense = rng.random((12, 20, 9)).astype(np.float32)
        dense[:, 8:16] = 0.0
    arg = torch.from_numpy(dense) if case == "tensor" else dense
    idx, org = encode_from_dense(codec, arg, **kw)
    jidx, jorg = jax_dense.encode_from_dense(jcodec, dense, **kw)
    ref = LeafGrid.from_dense("d", dense, **kw)
    np.testing.assert_array_equal(org, ref.origins)
    np.testing.assert_array_equal(org, jorg)
    np.testing.assert_array_equal(idx, codec.encode_leaves(ref.leaves))
    bad = (idx != np.asarray(jidx)).reshape(-1)
    assert not (bad & ~_jax_near_ties(jcodec, jparams, ref.leaves)).any()
    if case == "tolerance":
        np.testing.assert_array_equal(org, [[8, 8, 8], [16, 0, 8]])


def test_encode_from_dense_channel_mismatch(codecs, rng):
    codec, jcodec, _ = codecs
    vol = rng.random((8, 8, 8, 3)).astype(np.float32)
    with pytest.raises(VqvdbError) as ours:
        encode_from_dense(codec, vol)
    with pytest.raises(Exception) as theirs:
        jax_dense.encode_from_dense(jcodec, vol)
    assert str(ours.value) == str(theirs.value)


def test_dense_file_round_trip_and_multigrid(codecs, rng, tmp_path):
    """encode_dense_to_file writes the file compress writes for
    LeafGrid.from_dense; decode_file_to_dense of a two-grid file equals the
    sparse path per grid."""
    codec, _, _ = codecs
    g = _sparse_grid(rng, bdims=(3, 4, 2), fill=0.6)
    vol, lo = g.to_dense()
    path, ref = tmp_path / "dense.vqvdb", tmp_path / "ref.vqvdb"
    for kw in ({}, dict(format_version=5, compression="lz4")):
        stats = encode_dense_to_file(codec, vol, path, name="density", origin=lo, **kw)
        codec.compress(LeafGrid.from_dense("density", vol, origin=lo), ref, **kw)
        assert stats == {"leaves": g.num_leaves, "bytes": ref.stat().st_size}
        assert path.read_bytes() == ref.read_bytes()
    g2 = _sparse_grid(rng, bdims=(3, 2, 2), fill=0.7)
    g2.name = "temperature"
    codec.compress([g, g2], path)
    out = decode_file_to_dense(codec, path)
    assert [o["name"] for o in out] == ["density", "temperature"]
    grids, _ = codec.decompress(path)
    for o, grid in zip(out, grids):
        host, hlo = grid.to_dense()
        np.testing.assert_array_equal(o["dense"].numpy(), host)
        np.testing.assert_array_equal(o["lo"], hlo)


def test_api_dense_wrappers(codecs, rng, tmp_path):
    codec, _, _ = codecs
    g = _sparse_grid(rng, bdims=(2, 2, 2), fill=1.0)
    vol, lo = g.to_dense()
    path = tmp_path / "api.vqvdb"
    assert api.encode_dense(vol, codec, path, origin=lo)["leaves"] == 8
    (out,) = api.decode_dense(path, codec)
    assert out["dense"].shape == vol.shape
    grids, _ = api.decode(path, codec)
    np.testing.assert_array_equal(out["dense"].numpy(), grids[0].to_dense()[0])


def _shipped(name, k=None):
    """A shipped artifact on a CPU codec; `k` grows its codebook with noisy
    copies of its codes (u16 indices past 256)."""
    import dataclasses

    tree, cfg = api.load_model(MODELS / f"{name}.vqmodel")
    if k is not None:
        e = np.asarray(tree["vq"]["embedding"], np.float32)
        noise = np.random.default_rng(4).standard_normal((k - e.shape[0], e.shape[1]))
        big = np.concatenate([e, e[: k - e.shape[0]] + 0.02 * e.std() * noise.astype(np.float32)])
        tree = dict(tree, vq=dict(tree["vq"], embedding=big, embed_avg=big.copy(),
                                  cluster_size=np.zeros(k, np.float32)))
        cfg = dataclasses.replace(cfg, num_embeddings=k)
    return VQCodec(tree, cfg, CodecConfig(batch_size=BATCH, compute_dtype="float32"),
                   device="cpu")


@pytest.mark.parametrize("name,k", [("scalar", 512), ("vec3", None)])
def test_u16_and_vec3_dense_round_trips(rng, name, k):
    """The flagship grown to K = 512 (u16 indices, int16 bits on the device)
    and the vec3 artifact: dense decode equals the sparse path, dense encode
    the sparse encode (the JAX side is held above)."""
    codec = _shipped(name, k)
    c = codec.mcfg.in_channels
    g = _sparse_grid(rng, bdims=(3, 2, 2), fill=0.8, channels=c)
    if c == 3:
        g.leaves = g.leaves * 2 - 1
    idx = codec.encode_leaves(g.leaves)
    assert idx.dtype == (np.uint16 if k else np.uint8)
    dense, lo = decode_to_dense(codec, idx, g.origins)
    host, _ = _sparse_dense(codec, idx, g)
    assert dense.shape[-1] == c
    np.testing.assert_array_equal(dense.numpy(), host)
    idx2, org2 = encode_from_dense(codec, dense, origin=lo)
    ref = LeafGrid.from_dense("d", host, origin=lo)
    np.testing.assert_array_equal(org2, ref.origins)
    np.testing.assert_array_equal(idx2, codec.encode_leaves(ref.leaves))


def test_mesh_path_raises(codecs, rng):
    """The dense paths refuse a multi-process mesh (they build host-global
    inputs), as the JAX package's do; `data_parallel=` / `mesh=` give a mesh
    codec on the CPU."""
    from vqvdb_tpu_torch.parallel.mesh import Mesh, make_mesh

    codec, _, _ = codecs
    g = _sparse_grid(rng, bdims=(2, 2, 2), fill=1.0)
    idx = codec.encode_leaves(g.leaves)
    codec.mesh = Mesh((torch.device("cpu"),), 2, 1, group=object())
    try:
        with pytest.raises(VqvdbError, match="one process"):
            decode_to_dense(codec, idx, g.origins)
        with pytest.raises(VqvdbError, match="one process"):
            encode_from_dense(codec, np.zeros((8, 8, 8), np.float32))
    finally:
        codec.mesh = None
    for kw, size in ((dict(data_parallel=True), 1), (dict(mesh=make_mesh(2, "cpu")), 2)):
        assert api.make_codec(MODELS / "scalar.vqmodel", device="cpu", batch_size=64,
                              **kw).mesh.size == size
    with pytest.raises(ValueError, match="divide evenly"):
        api.make_codec(MODELS / "scalar.vqmodel", device="cpu", batch_size=63,
                       mesh=make_mesh(2, "cpu"))
