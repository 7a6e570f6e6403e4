"""The port's Houdini shim (`vqvdb_tpu_torch.integrations.houdini`) against
the JAX package's, on the CPU, through the fake `hou` module.

Both shims cook the same geometry with codecs of the same small model
(reference arch, D=32, K=64, batch 32, f32): through the geometry-file
bridge (plain and Houdini's default blosc / half-float save), the
voxel-sampling fallback of a VDB prim and of a Volume prim. Their `.vqvdb`
files must be byte-identical wherever the indices are equal; indices may
differ only on near-tie rows (best and runner-up JAX scores within NEAR_TIE
relative). The decoder cook builds the same VDB prims from one file, leaves
within ATOL. With a model path and device="cpu" the cooks write what
`api.encode` / `api.decode` write.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import fake_hou
from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.integrations import houdini as jhoudini
from vqvdb_tpu.models.quantizer import VQState
from vqvdb_tpu.models.vqvae import VQVAEParams
from vqvdb_tpu.models.vqvae import encoder_apply as jax_encoder_apply
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.train.synthetic import smoke_grid
from vqvdb_tpu.vdb.grid import LeafGrid as JaxLeafGrid
from vqvdb_tpu_torch import api
from vqvdb_tpu_torch.core.artifact import save_model
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_to_jax
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.integrations import houdini
from vqvdb_tpu_torch.models.vqvae import init_vqvae_params
from vqvdb_tpu_torch.runtime.codec import VQCodec

torch.set_num_threads(2)

NEAR_TIE = 1e-5
ATOL = 1e-5
BATCH = 32


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(port codec, JAX codec, JAX params, JAX config, .vqmodel path)."""
    kw = dict(embedding_dim=32, num_embeddings=64)
    cfg = ModelConfig(**kw)
    params = init_vqvae_params(torch.Generator().manual_seed(0), cfg)
    tree = params_to_jax(params)
    t = jax.tree.map(jnp.asarray, tree)
    jp = VQVAEParams(encoder=t["encoder"], decoder=t["decoder"], vq=VQState(**t["vq"]))
    jcfg = JaxModelConfig(**kw)
    path = tmp_path_factory.mktemp("model") / "m.vqmodel"
    save_model(path, params, cfg)
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=BATCH, compute_dtype="float32"),
                    device="cpu")
    jcodec = JaxCodec(jp, jcfg, JaxCodecConfig(batch_size=BATCH, compute_dtype="float32"))
    return codec, jcodec, jp, jcfg, path


@pytest.fixture
def hou(monkeypatch):
    monkeypatch.setitem(sys.modules, "hou", fake_hou)
    return fake_hou


def _grid(seed, name="density"):
    g = smoke_grid(24, seed=seed)
    return JaxLeafGrid(name, g.origins, g.leaves)


def _read(path):
    with VqvdbReader(path) as r:
        return r.read_grid()


def _assert_same_file(ours, theirs, leaves, jp, jcfg):
    """Byte-identical files, or files that differ only in near-tie indices."""
    a, b = ours.read_bytes(), theirs.read_bytes()
    (ma, ia, oa), (mb, ib, ob) = _read(ours), _read(theirs)
    assert len(a) == len(b) and ma.name == mb.name and ma.total_blocks == mb.total_blocks
    np.testing.assert_array_equal(oa, ob)
    np.testing.assert_array_equal(ma.transform, mb.transform)
    if np.array_equal(ia, ib):
        assert a == b
        return
    z = np.asarray(jax_encoder_apply(jp.encoder, jnp.asarray(leaves), jcfg)).reshape(-1, 32)
    e = np.asarray(jp.vq.embedding)
    two = np.sort((e * e).sum(1)[None] - 2.0 * z @ e.T, axis=1)[:, :2]
    ties = (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))
    assert not ((ia.reshape(-1) != ib.reshape(-1)) & ~ties).any()


def _cook_both(hou, model, tmp_path, geo_kw, prims):
    codec, jcodec, jp, jcfg, _ = model
    out = {}
    for label, shim, c in (("ours", houdini, codec), ("theirs", jhoudini, jcodec)):
        node = hou.FakeNode(hou.FakeGeometry(), input_geometry=hou.FakeGeometry(
            prims=prims(), **geo_kw))
        path = tmp_path / f"{label}.vqvdb"
        out[label] = shim.cook_encoder(outputpath=str(path), model=c, batchsize=BATCH,
                                       node=node)
        if label == "ours":
            (grid,) = houdini._grids_from_hou_node(node)
    assert out["ours"]["leaves"] == out["theirs"]["leaves"] == grid.num_leaves
    _assert_same_file(tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb", grid.leaves,
                      jp, jcfg)
    return grid


@pytest.mark.parametrize("default_save", [False, True], ids=["plain", "houdini_default"])
def test_geometry_file_bridge_matches_jax(hou, model, tmp_path, capsys, default_save):
    src = _grid(7 + default_save)
    grid = _cook_both(hou, model, tmp_path,
                      dict(leafgrids=[src], houdini_default_save=default_save),
                      lambda: [hou.FakeVDB(src)])
    assert grid.num_leaves == src.num_leaves  # the sparse bridge, not the fallback
    assert "falling back" not in capsys.readouterr().err


def test_sampling_fallback_matches_jax(hou, model, tmp_path, capsys):
    src = _grid(8)
    grid = _cook_both(hou, model, tmp_path, dict(leafgrids=[src], fail_save=True),
                      lambda: [hou.FakeVDB(src)])
    assert grid.num_leaves >= src.num_leaves  # dense resampling re-activates zero leaves
    assert "falling back to dense prim sampling" in capsys.readouterr().err


def test_volume_prim_matches_jax(hou, model, tmp_path):
    dense = np.random.default_rng(0).random((16, 16, 8), np.float32)
    grid = _cook_both(hou, model, tmp_path, dict(fail_save=True),
                      lambda: [hou.FakeVolume("fog", dense)])
    assert grid.name == "fog" and grid.num_leaves == 4


def test_decoder_builds_the_jax_prims(hou, model, tmp_path):
    codec, jcodec, _, _, _ = model
    src = _grid(9)
    path = tmp_path / "d.vqvdb"
    houdini.cook_encoder(outputpath=str(path), model=codec, batchsize=BATCH, grids=[src])
    geos = {}
    for label, shim, c in (("ours", houdini, codec), ("theirs", jhoudini, jcodec)):
        geos[label] = hou.FakeGeometry()
        grids = shim.cook_decoder(inputfile=str(path), model=c, batchsize=BATCH,
                                  node=hou.FakeNode(geos[label]))
        assert len(grids) == 1 and len(geos[label].loaded_files) == 1
    (a,), (b,) = geos["ours"].prims(), geos["theirs"].prims()
    assert a.type() == b.type() == hou.primType.VDB
    assert a.attribValue("name") == b.attribValue("name") == "density"
    oa, ob = np.lexsort(a._lg.origins.T), np.lexsort(b._lg.origins.T)
    np.testing.assert_array_equal(a._lg.origins[oa], b._lg.origins[ob])
    np.testing.assert_allclose(a._lg.leaves[oa], b._lg.leaves[ob], atol=ATOL, rtol=0)


def test_model_path_cooks_write_what_api_writes(model, tmp_path):
    """With a .vqmodel path and device="cpu" (the default compute dtype,
    bf16), the cooks are api.encode / api.decode; vdbname selects a grid."""
    path = model[4]
    a, b = _grid(5), _grid(6, "velocity_mag")
    stats = houdini.cook_encoder(outputpath=str(tmp_path / "c.vqvdb"), model=str(path),
                                 batchsize=BATCH, grids=[a, b], device="cpu")
    api.encode([a, b], path, tmp_path / "api.vqvdb", batch_size=BATCH, device="cpu")
    assert stats["leaves"] == a.num_leaves + b.num_leaves
    assert (tmp_path / "c.vqvdb").read_bytes() == (tmp_path / "api.vqvdb").read_bytes()
    grids = houdini.cook_decoder(inputfile=str(tmp_path / "c.vqvdb"), model=str(path),
                                 batchsize=BATCH, vdbname="velocity_mag", device="cpu")
    want, _ = api.decode(tmp_path / "c.vqvdb", path, batch_size=BATCH, device="cpu",
                         grids="velocity_mag")
    assert [g.name for g in grids] == ["velocity_mag"]
    np.testing.assert_array_equal(grids[0].leaves, want[0].leaves)
    np.testing.assert_array_equal(grids[0].origins, b.origins)


def test_cook_errors_match_jax(hou, model):
    with pytest.raises(ValueError, match="grids") as ours:
        houdini.cook_encoder(outputpath="x.vqvdb", model="m")
    with pytest.raises(ValueError) as theirs:
        jhoudini.cook_encoder(outputpath="x.vqvdb", model="m")
    assert str(ours.value) == str(theirs.value)
    node = hou.FakeNode(hou.FakeGeometry())  # no input wired
    with pytest.raises(ValueError, match="no connected input"):
        houdini.cook_encoder(outputpath="x.vqvdb", model=model[0], node=node)
