"""The port's mesh in one process (`vqvdb_tpu_torch/parallel/mesh.py`,
`VQCodec(mesh=)`, the dense paths' mesh form, `native_io.copy_into`) on CPU
meshes of 1, 2, 4 and 8 entries (the JAX package's 8-device mesh), in f32,
and the fixed-shape row blocks that keep a row's bits at any shard size
(`models/blocks.py::row_wise`).

A CPU mesh runs its shards one after another with the same arithmetic, so:
  * mesh files are byte-identical to the port's single-device codec's, and
    decompress / dense decode / dense encode bit-identical (v3, v5-lz4,
    v6-int8, a ragged tail, residual VQ);
  * mesh indices equal the JAX package's 8-device mesh codec's (the
    conftest's virtual CPU devices) except on near-ties: rows whose best and
    runner-up JAX scores are within 1e-5 relative;
  * `copy_into` writes the bytes the JAX binding writes.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models import blocks as jblocks
from vqvdb_tpu.models.vqvae import encoder_features as jax_encoder_features
from vqvdb_tpu.models.vqvae import init_vqvae_params
from vqvdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vqvdb_tpu.runtime import native_io as jax_native_io
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_to_jax, tree_to_torch
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.models.vqvae import init_vqvae_params as port_init
from vqvdb_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_decode,
    make_sharded_encode,
    make_sharded_eval_step,
    make_sharded_train_step,
    replicate,
    shard_batch,
)
from vqvdb_tpu_torch.runtime import native_io
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.runtime.dense import decode_to_dense, encode_from_dense
from vqvdb_tpu_torch.tools import batch_invariance
from vqvdb_tpu_torch.train import train
from vqvdb_tpu_torch.utils.errors import ConfigError
from vqvdb_tpu_torch.vdb.grid import LeafGrid

torch.set_num_threads(2)

BATCH = 16
NEAR_TIE = 1e-5
PACKED = dict(embedding_dim=32, num_embeddings=64, encoder_arch="packed")
RVQ2 = dict(embedding_dim=16, num_embeddings=32, num_quantizers=2, encoder_arch="packed_lite")


def _tree(kw, seed=0):
    jparams = jax.jit(init_vqvae_params, static_argnums=1)(jax.random.key(seed),
                                                             JaxModelConfig(**kw))
    return jparams, jax.tree.map(np.asarray, jparams._asdict())


@pytest.fixture(scope="module")
def packed():
    jparams, tree = _tree(PACKED)
    return jparams, tree, ModelConfig(**PACKED)


def _codec(tree, cfg, mesh=None, **kw):
    opts = dict(batch_size=BATCH, compute_dtype="float32", **kw)
    return VQCodec(tree, cfg, CodecConfig(**opts), device="cpu" if mesh is None else None,
                   mesh=mesh)


def _grids(rng, channels=1):
    """Three grids: a ragged tail (37 = 2 x 16 + 5 leaves), a full batch,
    and a grid shorter than one shard of the 4-mesh (3 leaves)."""
    out = []
    for i, n in enumerate((37, 16, 3)):
        origins = (np.stack(np.unravel_index(np.arange(n), (8, 8, 8)), 1) * 8).astype(np.int32)
        out.append(LeafGrid(f"g{i}", origins, rng.random((n, 8, 8, 8, channels), np.float32)))
    return out


TIERS = {"v3": {}, "v5_lz4": dict(format_version=5, compression="lz4"),
         "v6_int8": dict(residual="int8")}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_mesh_files_are_byte_identical(packed, rng, tmp_path, size, tier):
    _, tree, cfg = packed
    grids = _grids(rng)
    single, mesh = _codec(tree, cfg), _codec(tree, cfg, make_mesh(size, "cpu"))
    single.compress(grids, tmp_path / "single.vqvdb", **TIERS[tier])
    mesh.compress(grids, tmp_path / "mesh.vqvdb", **TIERS[tier])
    assert (tmp_path / "single.vqvdb").read_bytes() == (tmp_path / "mesh.vqvdb").read_bytes()
    want, _ = single.decompress(tmp_path / "single.vqvdb")
    got, _ = mesh.decompress(tmp_path / "single.vqvdb")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.origins, b.origins)
        np.testing.assert_array_equal(a.leaves, b.leaves)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_mesh_residual_vq_and_streams_are_byte_identical(rng, tmp_path, size):
    """A two-stage model (two nearest-code and dequantize launches per
    shard on the card), and compress_stream / encode_leaves on the mesh."""
    _, tree = _tree(RVQ2, seed=1)
    cfg = ModelConfig(**RVQ2)
    grids = _grids(rng)
    single, mesh = _codec(tree, cfg), _codec(tree, cfg, make_mesh(size, "cpu"))
    single.compress(grids, tmp_path / "single.vqvdb", residual="f16")
    mesh.compress(grids, tmp_path / "mesh.vqvdb", residual="f16")
    assert (tmp_path / "single.vqvdb").read_bytes() == (tmp_path / "mesh.vqvdb").read_bytes()

    class Stream:
        name, transform, channels = "g0", np.eye(4, dtype=np.float32), 1

        def __init__(self, g):
            self.num_leaves, self.origins, self.leaves = g.num_leaves, g.origins, g.leaves

        def leaf_batches(self, bs):
            for s in range(0, self.num_leaves, 7):
                yield self.leaves[s:s + 7]

    mesh.compress_stream(Stream(grids[0]), tmp_path / "stream.vqvdb")
    single.compress(LeafGrid("g0", grids[0].origins, grids[0].leaves), tmp_path / "g0.vqvdb")
    assert (tmp_path / "stream.vqvdb").read_bytes() == (tmp_path / "g0.vqvdb").read_bytes()
    idx = mesh.encode_leaves(grids[0].leaves)
    np.testing.assert_array_equal(idx, single.encode_leaves(grids[0].leaves))
    np.testing.assert_array_equal(mesh.decode_indices(idx), single.decode_indices(idx))


def test_mesh_indices_match_jax_mesh_codec(packed, rng):
    """The port's 4-mesh against the JAX package's 8-device mesh codec on
    the same leaves: indices equal except on near-ties of the JAX scores."""
    jparams, tree, cfg = packed
    jcodec = JaxCodec(jparams, JaxModelConfig(**PACKED),
                      JaxCodecConfig(batch_size=BATCH, compute_dtype="float32"),
                      mesh=jax_make_mesh(8))
    leaves = rng.random((37, 8, 8, 8, 1), np.float32)
    got = _codec(tree, cfg, make_mesh(4, "cpu")).encode_leaves(leaves).reshape(-1)
    want = np.asarray(jcodec.encode_leaves(leaves)).reshape(-1)
    h = np.asarray(jax_encoder_features(jparams.encoder, jnp.asarray(leaves),
                                        JaxModelConfig(**PACKED)))
    m, c = jcodec._score_mc
    scores = h.reshape(-1, h.shape[-1]) @ np.asarray(m) + np.asarray(c)
    bad = np.flatnonzero(got != want)
    two = np.sort(scores[bad], axis=1)[:, :2]
    assert bad.size <= got.size // 100
    assert ((two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))).all()


def test_mesh_rejects_indivisible_batch_and_probes(packed):
    """As tests/test_parallel.py:131-150: a batch that does not divide over
    the mesh raises; the latent probe runs one row per shard."""
    _, tree, cfg = packed
    with pytest.raises(ValueError, match="divide evenly"):
        VQCodec(tree, cfg, CodecConfig(batch_size=10), mesh=make_mesh(4, "cpu"))
    for size in (1, 2, 4):
        codec = _codec(tree, cfg, make_mesh(size, "cpu"))
        assert codec.check_latent_shape() == (4, 4, 4)


def test_sharded_steps_replicate_and_shard_batch(packed, rng):
    _, tree, cfg = packed
    mesh = make_mesh(4, "cpu")
    codec = _codec(tree, cfg, mesh)
    leaves = rng.random((BATCH, 8, 8, 8, 1), np.float32)
    shards = shard_batch(leaves, mesh)
    assert [s.shape[0] for s in shards] == [4] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), leaves)
    idx = make_sharded_encode(mesh, codec)(shards)
    want = codec._encode_step(torch.from_numpy(leaves))
    assert torch.equal(torch.cat(idx), want)
    (full, *_) = make_sharded_encode(mesh, codec, replicate_out=True)(shards)
    assert torch.equal(full, want)
    rec = make_sharded_decode(mesh, codec)(idx)
    assert torch.equal(torch.cat(rec), codec._decode_step(want))
    reps = replicate({"a": torch.ones(3), "b": [torch.zeros(2)], "n": 5}, mesh)
    assert len(reps) == 4 and all(r["n"] == 5 and torch.equal(r["a"], torch.ones(3))
                                  for r in reps)
    with pytest.raises(ValueError, match="divide evenly"):
        shard_batch(leaves[:10], mesh)
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


def test_sharded_train_and_eval_steps_of_one_device(packed, rng):
    """A mesh of one device in one process trains as without a mesh; a mesh
    of several devices in one process is refused (one process per device)."""
    _, tree, cfg = packed
    tcfg = train.TrainConfig(batch_size=8, compute_dtype="float32", lr=1e-3)
    opt = train.make_optimizer(tcfg, 10)
    batch = torch.from_numpy(rng.random((8, 8, 8, 8, 1), np.float32))
    mesh = make_mesh(1, "cpu")
    state = train.make_train_state(cfg, tcfg, 10, "cpu",
                                   params=port_init(torch.Generator().manual_seed(0), cfg))
    a, ma, za = train.train_step(state, batch, opt, cfg, tcfg)
    b, mb, zb = make_sharded_train_step(mesh, opt, cfg, tcfg)(state, batch)
    assert torch.equal(za, zb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(train.tree_leaves(a.params), train.tree_leaves(b.params)):
        assert torch.equal(x, y)
    ev = make_sharded_eval_step(mesh, cfg, tcfg)(a.params, batch)
    assert all(torch.equal(v, train.eval_step(a.params, batch, cfg, tcfg)[k])
               for k, v in ev.items())
    for make in (lambda m: make_sharded_train_step(m, opt, cfg, tcfg),
                 lambda m: make_sharded_eval_step(m, cfg, tcfg)):
        with pytest.raises(ConfigError, match="one process per device"):
            make(make_mesh(2, "cpu"))


def _sparse_grid(rng, bdims, fill=0.5):
    active = rng.random(int(np.prod(bdims))) < fill
    active[0] = active[-1] = True
    (flat,) = np.nonzero(active)
    bi = np.stack(np.unravel_index(flat, bdims), axis=1)
    return LeafGrid("density", (bi * 8).astype(np.int32),
                    rng.random((flat.size, 8, 8, 8, 1), np.float32))


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("residual", [None, "int8", "f16"])
def test_mesh_dense_paths_are_bit_identical(packed, rng, tmp_path, size, residual):
    """As tests/test_dense.py:226-330: the x-slab decode (5 block planes over
    `size` slabs, one of them empty on the 4-mesh) and the slab encode equal
    the single-device paths bit for bit, a v6 correction included."""
    _, tree, cfg = packed
    single, mesh = _codec(tree, cfg), _codec(tree, cfg, make_mesh(size, "cpu"))
    g = _sparse_grid(rng, (5, 3, 2))
    path = tmp_path / "g.vqvdb"
    single.compress(g, path, residual=residual)
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader

    with VqvdbReader(path) as r:
        r.next_grid_metadata()
        idx, org, sc, res = r.next_batch_residual(10 ** 6)
    want, lo = decode_to_dense(single, idx, org, scales=sc, residual=res, background=0.25)
    got, glo = decode_to_dense(mesh, idx, org, scales=sc, residual=res, background=0.25)
    np.testing.assert_array_equal(lo, glo)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    dense = want.numpy()[:35]  # x no multiple of 8 and of the slabs
    i1, o1 = encode_from_dense(single, dense, origin=lo, background=0.25)
    i2, o2 = encode_from_dense(mesh, torch.from_numpy(dense), origin=lo, background=0.25)
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("shape,dtype,order", [((3, 1000), np.float32, "C"),
                                               ((700, 512), np.float32, "C"),  # > 1 MiB
                                               ((40, 64), np.uint8, "C"),
                                               ((6, 10), np.float32, "F")])
def test_copy_into_matches_the_jax_binding(rng, shape, dtype, order):
    src = np.asarray(rng.random(shape) * 200, dtype=dtype, order=order)
    ours = np.zeros(shape, dtype)
    theirs = np.zeros(shape, dtype)
    native_io.copy_into(ours, src)
    native_io.copy_into(ours[1:2], src[:1], threads=2)
    jax_native_io.copy_into(theirs, src)
    jax_native_io.copy_into(theirs[1:2], src[:1], threads=2)
    assert ours.tobytes() == theirs.tobytes()


def test_replicated_constants_are_the_first_devices_bits(packed):
    """Each mesh entry's weights and fold constants hold the first entry's
    bits (on the card: copies of cuda:0's, not folds made anew per card)."""
    _, tree, cfg = packed
    codec = _codec(tree, cfg, make_mesh(2, "cpu"))
    first = codec._consts[codec.device]
    for rep in replicate(first, codec.mesh):
        assert torch.equal(rep["score_prep"].operand, first["score_prep"].operand)
        assert torch.equal(rep["folded_tail"]["k"], first["folded_tail"]["k"])
    assert params_to_jax(codec.params)["vq"]["embedding"].shape == (64, 32)


@pytest.mark.parametrize("op", ["conv3d", "row_blocks"])
def test_row_blocks_and_blocked_conv3d_match_whole_and_jax(rng, op):
    """37 rows in blocks of ROW_BLOCK["cpu"] = 16 (a ragged last block of 5
    padded with 11 zero rows): every call takes 16 rows, the output has
    37 rows, each as the whole-batch call (training's form) and the JAX
    package compute it, and a row's bits do not depend on where the batch
    starts (a shard's rows sit elsewhere in its blocks)."""
    n, rows = 37, blocks.ROW_BLOCK["cpu"]
    if op == "conv3d":
        p = {"w": (0.1 * rng.standard_normal((3, 3, 3, 8, 16))).astype(np.float32),
             "b": rng.standard_normal(16).astype(np.float32)}
        x = rng.standard_normal((n, 4, 4, 4, 8)).astype(np.float32)
        port = tree_to_torch(p, torch.device("cpu"))
        ref = np.asarray(jblocks.conv3d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                        padding=1))

        def fn(t):
            return blocks.conv3d(port, t, padding=1)
    else:
        b = rng.standard_normal((64, 16)).astype(np.float32)
        x = rng.standard_normal((n, 64)).astype(np.float32)
        ref = np.asarray(jnp.asarray(x) @ jnp.asarray(b))

        def fn(t):
            return blocks.row_blocks(t, torch.from_numpy(b))
    xt = torch.from_numpy(x)
    calls = []

    def spy(t):
        calls.append(t.shape[0])
        return fn(t)

    with torch.inference_mode():
        got = blocks.row_wise(spy, xt)
    assert calls == [rows] * -(-n // rows)
    assert tuple(got.shape) == ref.shape
    whole = fn(xt)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        for start in (3, rows, 2 * rows, n - 1):
            assert torch.equal(fn(xt[start:]), got[start:]), start


def test_cpu_stages_keep_a_rows_bits():
    """`tools/batch_invariance.py` on the CPU: every stage of the flagship's,
    the reference arch's and scalar_rvq2's encode and decode steps (the
    kernels' plain versions included) gives a row of a 32-leaf batch the
    same bits in blocks of 16, 8, 4, 2 and 1 leaves, in bf16 and f32."""
    out = batch_invariance.stages("cpu", n=32, sizes=(16, 8, 4, 2, 1))
    assert set(out["stages"]) == set(batch_invariance.MODELS)
    for model, by_dtype in out["stages"].items():
        for dtype, stages in by_dtype.items():
            moved = {k: v for k, v in stages.items() if not all(v.values())}
            assert not moved, (model, dtype, moved)
