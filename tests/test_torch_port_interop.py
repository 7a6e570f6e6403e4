"""The port's interop surfaces (`vqvdb_tpu_torch.interop`,
`core/torch_import.py`, `models/vqvae.py::encode_to_indices` /
`decode_from_indices`) against the JAX package's, on the CPU in f32.

Both packages get the same params (the committed artifacts, or small
models drawn by the port's seeded initialiser). Written files must be
byte-identical: ONNX graphs (all four single-stage artifacts and a K=512
model), the `.vqmodel` of an imported `.pth`, the embed header. `.pth`
files embed their archive's name, so they are compared key by key with
torch.equal. Numerics: indices equal except on near-tie rows (best and
runner-up JAX scores within NEAR_TIE relative; residual VQ stage by stage),
leaves within ATOL (the reference's own ONNX validation threshold).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core import artifact as jartifact
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.core.torch_import import import_state_dict as jax_import_state_dict
from vqvdb_tpu.interop import onnx_export as jonnx
from vqvdb_tpu.interop import torch_export as jexport
from vqvdb_tpu.interop.embed import write_embed_header as jax_write_embed_header
from vqvdb_tpu.models.quantizer import VQState
from vqvdb_tpu.models.vqvae import VQVAEParams
from vqvdb_tpu.models.vqvae import decode_from_indices as jax_decode_from_indices
from vqvdb_tpu.models.vqvae import encode_to_indices as jax_encode_to_indices
from vqvdb_tpu.models.vqvae import encoder_apply as jax_encoder_apply
from vqvdb_tpu.utils.errors import ArtifactError as JaxArtifactError
from vqvdb_tpu_torch.core import artifact
from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.torch_import import import_state_dict, import_torch_checkpoint
from vqvdb_tpu_torch.core.weights import params_from_jax, params_to_jax
from vqvdb_tpu_torch.interop import export_onnx, onnx_export, torch_export
from vqvdb_tpu_torch.interop.embed import write_embed_header
from vqvdb_tpu_torch.interop.onnx_eval import run_model
from vqvdb_tpu_torch.models.vqvae import (
    decode_from_indices,
    encode_to_indices,
    init_vqvae_params,
)
from vqvdb_tpu_torch.utils.errors import ArtifactError

torch.set_num_threads(2)

MODELS = Path(__file__).parent.parent / "models"
NEAR_TIE = 1e-5
ATOL = 1e-5

SMALL = dict(embedding_dim=32, num_embeddings=64)
CFGS = {
    "scalar": dict(SMALL),
    "vec3": dict(SMALL, in_channels=3),
    "packed": dict(SMALL, encoder_arch="packed"),
    "rvq2": dict(SMALL, num_quantizers=2),
}


def jax_params(tree):
    """VQVAEParams of the JAX package from a JAX-layout numpy tree."""
    t = jax.tree.map(jnp.asarray, tree)
    return VQVAEParams(encoder=t["encoder"], decoder=t["decoder"], vq=VQState(**t["vq"]))


def jax_tree(p):
    """VQVAEParams -> nested dicts of numpy arrays, as the port's tree."""
    return jax.tree.map(np.asarray, dict(p._asdict(), vq=p.vq._asdict()))


def flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def small(name, seed=0):
    """(numpy tree, port config, JAX params, JAX config) of a small model
    drawn by the port's initialiser."""
    kw = CFGS[name] if isinstance(name, str) else name
    cfg = ModelConfig(**kw)
    tree = params_to_jax(init_vqvae_params(torch.Generator().manual_seed(seed), cfg))
    return tree, cfg, jax_params(tree), JaxModelConfig(**kw)


def committed(name):
    tree, cfg = artifact.load_model(MODELS / f"{name}.vqmodel")
    return tree, cfg, jax_params(tree), JaxModelConfig(**dataclasses.asdict(cfg))


def leaves(cfg, n=4, seed=1):
    x = np.random.default_rng(seed).random((n, 8, 8, 8, cfg.in_channels), np.float32)
    return (2.0 * x - 1.0).astype(np.float32) if cfg.variant == "vec3" else x


def _near_ties(scores):
    two = np.sort(scores, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))


def assert_indices_match(got, want, jp, jcfg, x):
    """got / want [B,4,4,4(,S)]: equal except where a row first differs at
    a near-tie of that stage's JAX scores."""
    z = np.asarray(jax_encoder_apply(jp.encoder, jnp.asarray(x), jcfg))
    res = z.reshape(-1, jcfg.embedding_dim)
    books = np.asarray(jp.vq.embedding).reshape(-1, jcfg.num_embeddings, jcfg.embedding_dim)
    got = np.asarray(got).reshape(res.shape[0], -1)
    want = np.asarray(want).reshape(res.shape[0], -1)
    same = np.ones(res.shape[0], bool)
    for s, e in enumerate(books):
        scores = (e * e).sum(1)[None] - 2.0 * res @ e.T
        bad = same & (got[:, s] != want[:, s])
        assert not (bad & ~_near_ties(scores)).any(), f"stage {s}: rows differ off near-ties"
        same &= got[:, s] == want[:, s]
        res = res - e[want[:, s]]


# ---------------------------------------------------------------------------
# encode_to_indices / decode_from_indices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scalar", "vec3", "rvq2"])
def test_encode_decode_indices_match_jax(name):
    tree, cfg, jp, jcfg = small(name)
    params = params_from_jax(tree, cfg, "cpu")
    x = leaves(cfg, n=6)
    with torch.no_grad():
        idx = encode_to_indices(params, torch.from_numpy(x), cfg)
    want = np.array(jax_encode_to_indices(jp, jnp.asarray(x), jcfg))
    assert idx.dtype == torch.uint8 and tuple(idx.shape) == want.shape
    assert_indices_match(idx.numpy(), want, jp, jcfg, x)
    with torch.no_grad():
        got = decode_from_indices(params, torch.from_numpy(want), cfg)
    ref = np.asarray(jax_decode_from_indices(jp, jnp.asarray(want), jcfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_indices_beyond_256_codes_are_int32():
    """Beyond 256 codes the indices are uint16, as the JAX package's (the
    name is the test's first form, when the port returned int32)."""
    tree, cfg, jp, jcfg = small(dict(embedding_dim=16, num_embeddings=300))
    params = params_from_jax(tree, cfg, "cpu")
    x = leaves(cfg)
    with torch.no_grad():
        idx = encode_to_indices(params, torch.from_numpy(x), cfg)
        got = decode_from_indices(params, idx, cfg)
    want = np.asarray(jax_encode_to_indices(jp, jnp.asarray(x), jcfg))
    assert idx.dtype == torch.uint16 and idx.numpy().dtype == want.dtype == np.uint16
    assert_indices_match(idx.numpy(), want, jp, jcfg, x)
    ref = np.asarray(jax_decode_from_indices(jp, jnp.asarray(idx.numpy()), jcfg))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_decode_stem_rewrite_is_exact_and_chunked(monkeypatch):
    """decode_from_indices runs the decoder's stem conv as per-tap projected
    codebooks: within f32 rounding of the direct conv (decoder_apply of the
    looked-up rows; residual VQ summed over stages), nearer an f64 decode
    on the flagship; chunks of DECODE_CHUNK blocks give the same leaves up to
    the conv backend's batch-size-dependent rounding (within ATOL)."""
    from vqvdb_tpu_torch.models import vqvae

    tree, cfg = artifact.load_model(MODELS / "scalar.vqmodel")
    params = params_from_jax(tree, cfg, "cpu")
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (5, 4, 4, 4), np.uint8))
    with torch.no_grad():
        got = decode_from_indices(params, idx, cfg)
        direct = vqvae.decoder_apply(params["decoder"],
                                     params["vq"]["embedding"][idx.long()], cfg)
        p64 = jax.tree.map(lambda t: t.double(), params)
        exact = vqvae.decoder_apply(p64["decoder"], p64["vq"]["embedding"][idx.long()], cfg)
        monkeypatch.setattr(vqvae, "DECODE_CHUNK", 2)
        chunked = decode_from_indices(params, idx, cfg)
    torch.testing.assert_close(got, direct, rtol=0, atol=3e-5)
    assert (got.double() - exact).abs().max() < (direct.double() - exact).abs().max()
    torch.testing.assert_close(chunked, got, rtol=0, atol=ATOL)
    tree, cfg, _, _ = small("rvq2")
    params = params_from_jax(tree, cfg, "cpu")
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (3, 4, 4, 4, 2), np.uint8))
    with torch.no_grad():
        got = decode_from_indices(params, idx, cfg)
        e = params["vq"]["embedding"]
        z = e[0][idx[..., 0].long()] + e[1][idx[..., 1].long()]
        direct = vqvae.decoder_apply(params["decoder"], z, cfg)
    torch.testing.assert_close(got, direct, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# ONNX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scalar", "scalar_reference", "scalar_packed_lite", "vec3"])
def test_onnx_bytes_equal_jax_for_committed_artifacts(name):
    tree, cfg, jp, jcfg = committed(name)
    enc, dec = onnx_export.build_encoder_onnx(tree, cfg), onnx_export.build_decoder_onnx(tree, cfg)
    assert enc == jonnx.build_encoder_onnx(jp, jcfg)
    assert dec == jonnx.build_decoder_onnx(jp, jcfg)
    # The port's tensor tree gives the same bytes as its numpy tree.
    assert onnx_export.build_encoder_onnx(params_from_jax(tree, cfg, "cpu"), cfg) == enc


def test_onnx_uint16_form_equals_jax(tmp_path):
    tree, cfg, jp, jcfg = small(dict(embedding_dim=32, num_embeddings=512, encoder_arch="packed"))
    paths = export_onnx(tmp_path, params_from_jax(tree, cfg, "cpu"), cfg)
    assert Path(paths["encoder"]).read_bytes() == jonnx.build_encoder_onnx(jp, jcfg)
    assert Path(paths["decoder"]).read_bytes() == jonnx.build_decoder_onnx(jp, jcfg)
    x = leaves(cfg)
    got = run_model(paths["encoder"], {"input": np.moveaxis(x, -1, 1)})["output"]
    want = np.asarray(jax_encode_to_indices(jp, jnp.asarray(x), jcfg))
    assert got.dtype == np.uint16
    assert_indices_match(got, want, jp, jcfg, x)
    # encode_to_indices returns the JAX package's dtype, and its own decoder
    # and the exported one take it.
    params = params_from_jax(tree, cfg, "cpu")
    with torch.no_grad():
        idx = encode_to_indices(params, torch.from_numpy(x), cfg)
        rec = decode_from_indices(params, idx, cfg)
    assert idx.dtype == torch.uint16 and idx.numpy().dtype == want.dtype
    assert_indices_match(idx.numpy(), want, jp, jcfg, x)
    ref = np.asarray(jax_decode_from_indices(jp, jnp.asarray(idx.numpy()), jcfg))
    np.testing.assert_allclose(rec.numpy(), ref, atol=ATOL, rtol=0)
    onnx_rec = run_model(paths["decoder"], {"input": idx.numpy()})["output"]
    np.testing.assert_allclose(np.moveaxis(onnx_rec, 1, -1), ref, atol=ATOL, rtol=0)


def test_onnx_refuses_residual_vq_as_jax_does(tmp_path):
    tree, cfg, jp, jcfg = small("rvq2")
    with pytest.raises(ArtifactError, match="residual-VQ"):
        export_onnx(tmp_path / "a", tree, cfg)
    with pytest.raises(JaxArtifactError, match="residual-VQ"):
        jonnx.export_onnx(tmp_path / "b", jp, jcfg)


@pytest.mark.parametrize("name", ["scalar", "vec3", "packed"])
def test_onnx_eval_of_port_files_matches_jax_forward(name, tmp_path):
    tree, cfg, jp, jcfg = small(name, seed=3)
    paths = export_onnx(tmp_path, tree, cfg)
    x = leaves(cfg)
    want_idx = np.asarray(jax_encode_to_indices(jp, jnp.asarray(x), jcfg))
    got_idx = run_model(paths["encoder"], {"input": np.moveaxis(x, -1, 1)})["output"]
    assert got_idx.dtype == np.uint8
    assert_indices_match(got_idx, want_idx, jp, jcfg, x)
    want = np.asarray(jax_decode_from_indices(jp, jnp.asarray(want_idx), jcfg))
    got = run_model(paths["decoder"], {"input": want_idx})["output"]
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, atol=ATOL, rtol=0)


def test_embed_header_equals_jax(tmp_path):
    payload = bytes(range(256)) * 3 + b"\x00\xff"
    arrays = {"encoder_model_data": payload, "decoder_model_data": payload[::-1]}
    ours = write_embed_header(tmp_path / "a" / "bin_onnx.h", arrays)
    theirs = jax_write_embed_header(tmp_path / "b" / "bin_onnx.h", arrays)
    assert ours.read_bytes() == theirs.read_bytes()


# ---------------------------------------------------------------------------
# torch state dicts, .pth, TorchScript, import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scalar", "vec3"])
def test_state_dict_and_pth_equal_jax(name, tmp_path):
    tree, cfg, jp, jcfg = small(name)
    params = params_from_jax(tree, cfg, "cpu")
    ours, theirs = torch_export.export_state_dict(params, cfg), jexport.export_state_dict(jp, jcfg)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    torch_export.save_reference_checkpoint(tmp_path / "a.pth", params, cfg, epoch=7)
    jexport.save_reference_checkpoint(tmp_path / "b.pth", jp, jcfg, epoch=7)
    a = torch.load(tmp_path / "a.pth", weights_only=True)
    b = torch.load(tmp_path / "b.pth", weights_only=True)
    assert a["epoch"] == b["epoch"] == 7 and list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k

    # Import: the JAX importer's tree, and a .vqmodel byte-identical to its.
    back = import_torch_checkpoint(tmp_path / "b.pth", cfg)
    jback = jax_import_state_dict(b["state_dict"], jcfg)
    mine, theirs = flat(back), flat(jax_tree(jback))
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)
    artifact.save_model(tmp_path / "a.vqmodel", params_from_jax(back, cfg, "cpu"), cfg)
    jartifact.save_model(tmp_path / "b.vqmodel", jback, jcfg)
    assert (tmp_path / "a.vqmodel").read_bytes() == (tmp_path / "b.vqmodel").read_bytes()
    for k, v in params_to_jax(params)["encoder"]["pre_conv"].items():
        np.testing.assert_array_equal(back["encoder"]["pre_conv"][k], v)


def test_torch_export_refuses_what_jax_refuses():
    for kw in (CFGS["packed"], CFGS["rvq2"]):
        tree, cfg, jp, jcfg = small(kw)
        with pytest.raises(ValueError) as ours:
            torch_export.export_state_dict(tree, cfg)
        with pytest.raises(ValueError) as theirs:
            jexport.export_state_dict(jp, jcfg)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="reference encoder layout"):
        import_state_dict({}, ModelConfig(encoder_arch="packed"))


@pytest.mark.parametrize("name", ["scalar", "vec3"])
def test_torchscript_equals_jax(name, tmp_path):
    tree, cfg, jp, jcfg = small(name, seed=5)
    params = params_from_jax(tree, cfg, "cpu")
    torch_export.save_torchscript(tmp_path / "a.pt", params, cfg)
    jexport.save_torchscript(tmp_path / "b.pt", jp, jcfg)
    a, b = torch.jit.load(str(tmp_path / "a.pt")), torch.jit.load(str(tmp_path / "b.pt"))
    x = leaves(cfg)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad():
        ia, ib = a.encode(xt), b.encode(xt)
        assert ia.dtype == torch.int64 and torch.equal(ia, ib)
        da, db = a.decode(ia), b.decode(ib)
        assert torch.equal(da, db)
        mine = decode_from_indices(params, ia, cfg)
    np.testing.assert_allclose(np.moveaxis(da.numpy(), 1, -1), mine.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# export-checkpoint of the port's own training checkpoints
# ---------------------------------------------------------------------------

def test_export_checkpoint_of_a_port_training_run(tmp_path, capsys, monkeypatch):
    """Two train steps (16 train leaves at batch 8), then the CLI's
    export-checkpoint of the latest and of the best-val checkpoint: each
    .vqmodel byte-identical to save_model of the checkpoint's params and
    loadable by the JAX package, leaf for leaf."""
    import json

    # The JAX loader draws a template tree for the params' structure; the
    # jitted initialiser draws it in one program instead of op by op.
    monkeypatch.setattr(jartifact, "init_vqvae_params",
                        jax.jit(jartifact.init_vqvae_params, static_argnums=1))

    from vqvdb_tpu_torch.cli import main as cli
    from vqvdb_tpu_torch.train.checkpoint import CheckpointManager
    from vqvdb_tpu_torch.train.data import LeafDataset
    from vqvdb_tpu_torch.train.train import TrainConfig, make_train_state, train

    np.save(tmp_path / "a.npy", np.random.default_rng(0).random((20, 8, 8, 8), np.float32))
    cfg = ModelConfig(embedding_dim=16, num_embeddings=32)
    tcfg = TrainConfig(epochs=1, batch_size=8, compute_dtype="float32", val_fraction=0.2)
    ckpt = tmp_path / "ckpts"
    state, _ = train(LeafDataset([tmp_path / "a.npy"]), cfg, tcfg, checkpoint_dir=str(ckpt),
                     device="cpu", log_fn=lambda *_: None)
    assert state.step == 2
    flags = ["--embedding-dim", "16", "--num-embeddings", "32", "--device", "cpu"]
    template = make_train_state(cfg, TrainConfig(), 1, device="cpu")
    manager = CheckpointManager(ckpt)
    for best in (False, True):
        out = tmp_path / f"best{best}.vqmodel"
        assert cli(["export-checkpoint", str(ckpt), str(out), *flags]
                   + (["--best"] if best else [])) == 0
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        step, restored = manager.restore_best(template) if best else \
            (manager.latest_step(), manager.restore(manager.latest_step(), template))
        assert printed == {"checkpoint_step": step, "best": best, "model": str(out)}
        artifact.save_model(tmp_path / "direct.vqmodel", restored.params, cfg)
        assert out.read_bytes() == (tmp_path / "direct.vqmodel").read_bytes()
        loaded, lcfg = jartifact.load_model(out)
        assert dataclasses.asdict(lcfg) == dataclasses.asdict(cfg)
        want, got = flat(params_to_jax(restored.params)), flat(jax_tree(loaded))
        assert want.keys() == got.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert np.array_equal(params_to_jax(state.params)["vq"]["embedding"],
                          params_to_jax(manager.restore(2, template).params)["vq"]["embedding"])
    # A checkpoint of another graph (packed_stem adds an 8^3 stage) does not
    # fit the template: an error of the checkpoint, exit 1.
    rc = cli(["export-checkpoint", str(ckpt), str(tmp_path / "x.vqmodel"), *flags,
              "--encoder-arch", "packed_stem"])
    assert rc == 1 and "error:" in capsys.readouterr().err
