"""The plain reference against the port, at a tiny size on the CPU, and its
frozen readers and writer against the port's.

The reference imports nothing of the port; these tests import both."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import layers, packed, reference, v3, v4, vqmodel

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MODELS = ["scalar", "vec3"]
# artifact -> its plain reference module
ARCH = {"scalar": packed, "vec3": packed, "scalar_reference": reference}


def _codec(name, path=None, **kw):
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    params, cfg = load_model(path or ROOT / "models" / f"{name}.vqmodel")
    return VQCodec(params, cfg, CodecConfig(batch_size=32, **kw), device="cpu")


def _reference(name, rounding="float32", path=None):
    params, cfg = vqmodel.load(path or ROOT / "models" / f"{name}.vqmodel")
    return ARCH.get(name, reference).Model(params, cfg, torch.device("cpu"), rounding)


def _vec3_reference(tmp_path):
    """upstream's EncoderVec3 and DecoderVec3 at the notebook's D 64, drawn
    with the port's initialiser (K 512 keeps the CPU's test short)."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.models.vqvae import init_vqvae_params

    cfg = ModelConfig(in_channels=3, embedding_dim=64, num_embeddings=512,
                      encoder_arch="reference")
    path = tmp_path / "vec3_reference.vqmodel"
    save_model(path, init_vqvae_params(torch.Generator().manual_seed(7), cfg), cfg)
    return path


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_the_port_in_f32(name):
    idx = np.random.default_rng(1).integers(0, 256, (40, 4, 4, 4)).astype(np.uint8)
    got = _codec(name, compute_dtype="float32").decode_indices(idx)
    ref = _reference(name).decode(torch.from_numpy(idx)).numpy()
    # Both f32: the port folds the tail into one GEMM, so the sums differ
    # in their order only (~1e-6 of leaves in [-1, 1]).
    assert np.abs(got - ref).max() < 2e-5


@pytest.mark.parametrize("name", MODELS + ["scalar_reference", "vec3_reference"])
def test_encode_matches_the_port_in_f32(name, tmp_path):
    path = _vec3_reference(tmp_path) if name == "vec3_reference" else None
    c = 1 if name.startswith("scalar") else 3
    leaves = np.random.default_rng(2).random((40, 8, 8, 8, c)).astype(np.float32)
    got = _codec(name, path, compute_dtype="float32").encode_leaves(leaves)
    ref = _reference(name, path=path).encode(torch.from_numpy(leaves)).numpy()
    assert (got != ref).mean() < 0.01


@pytest.mark.parametrize("name", ["scalar_reference", "vec3_reference"])
def test_reference_arch_decode_matches_the_port_in_f32(name, tmp_path):
    path = _vec3_reference(tmp_path) if name == "vec3_reference" else None
    k = 256 if path is None else 512
    idx = np.random.default_rng(1).integers(0, k, (24, 4, 4, 4)).astype(np.uint16)
    got = _codec(name, path, compute_dtype="float32").decode_indices(idx)
    ref = _reference(name, path=path).decode(torch.from_numpy(idx.astype(np.int64))).numpy()
    assert np.abs(got - ref).max() < 2e-5


def test_a_reference_model_takes_only_its_architecture():
    params, cfg = vqmodel.load(ROOT / "models" / "scalar.vqmodel")
    with pytest.raises(ValueError):
        reference.Model(params, cfg, torch.device("cpu"))
    params, cfg = vqmodel.load(ROOT / "models" / "scalar_reference.vqmodel")
    with pytest.raises(ValueError):
        packed.Model(params, cfg, torch.device("cpu"))


def test_fp8_control_rounds_to_e4m3_under_a_scale():
    t = torch.linspace(-3.0, 3.0, 1001)
    r = layers.fp8(t)
    assert torch.allclose(r.abs().max(), t.abs().max())
    rel = ((r - t).abs() / t.abs().clamp(min=1e-3)).max()
    assert 0.01 < float(rel) < 0.07  # 3 mantissa bits: half an ulp is 1/16
    assert torch.equal(layers.fp8(r), r)


def test_fp8_control_decodes_coarser_than_float32():
    idx = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (16, 4, 4, 4)).astype(np.uint8))
    ref = _reference("scalar").decode(idx)
    ctl = _reference("scalar", "fp8").decode(idx)
    bf16 = _codec("scalar").decode_indices(idx.numpy())
    err_ctl = float((ctl - ref).square().mean().sqrt())
    err_bf16 = float((torch.from_numpy(bf16) - ref).square().mean().sqrt())
    assert err_ctl > 3 * err_bf16


@pytest.mark.parametrize("name", MODELS)
def test_artifact_reader_matches_the_port(name):
    from vqvdb_tpu_torch.core.artifact import load_model

    params, cfg = vqmodel.load(ROOT / "models" / f"{name}.vqmodel")
    want, want_cfg = load_model(ROOT / "models" / f"{name}.vqmodel")
    assert cfg == {k: getattr(want_cfg, k) for k in cfg}

    def flat(t, p=""):
        return ({f"{p}/{k}": v for k0, v0 in t.items() for k, v in flat(v0, f"{p}/{k0}").items()}
                if isinstance(t, dict) else {"": t})
    a, b = flat(params), flat(want)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_v3_files_match_the_ports_byte_for_byte(tmp_path):
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader, write_single_grid

    rng = np.random.default_rng(4)
    origins = (rng.integers(0, 64, (300, 3)) * 8).astype(np.int32)
    idx = rng.integers(0, 256, (300, 4, 4, 4)).astype(np.uint8)
    v3.write(tmp_path / "a.vqvdb", "density", origins, idx, 256)
    write_single_grid(tmp_path / "b.vqvdb", "density", idx, origins, 256)
    assert (tmp_path / "a.vqvdb").read_bytes() == (tmp_path / "b.vqvdb").read_bytes()
    k, ((name, o, i),) = v3.read(tmp_path / "b.vqvdb")
    assert (k, name) == (256, "density") and np.array_equal(o, origins) and np.array_equal(i, idx)
    with VqvdbReader(tmp_path / "a.vqvdb") as r:
        meta, got_i, got_o = r.read_grid()
    assert np.array_equal(got_i, idx) and np.array_equal(got_o, origins)


@pytest.mark.parametrize("k", [256, 512, 4096])
def test_v4_files_match_the_ports_byte_for_byte(tmp_path, k):
    from vqvdb_tpu_torch.format.vqvdb import GridMetadata, VqvdbReader, VqvdbWriter

    rng = np.random.default_rng(5)
    origins = (rng.integers(0, 64, (300, 3)) * 8).astype(np.int32)
    idx = rng.integers(0, k, (300, 4, 4, 4)).astype(np.uint8 if k <= 256 else np.uint16)
    v4.write(tmp_path / "a.vqvdb", "velocity", origins, idx, k)
    with VqvdbWriter(tmp_path / "b.vqvdb", version=4) as w:
        w.start_grid(GridMetadata(name="velocity", num_embeddings=k, latent_shape=(4, 4, 4),
                                  total_blocks=300))
        w.write_batch(idx, origins)
    assert (tmp_path / "a.vqvdb").read_bytes() == (tmp_path / "b.vqvdb").read_bytes()
    got_k, ((name, o, i),) = v4.read(tmp_path / "b.vqvdb")
    assert (got_k, name) == (k, "velocity") and np.array_equal(o, origins)
    assert i.dtype == idx.dtype and np.array_equal(i, idx)
    with VqvdbReader(tmp_path / "a.vqvdb") as r:
        meta, got_i, got_o = r.read_grid()
    assert np.array_equal(got_i, idx) and np.array_equal(got_o, origins)
    with pytest.raises(ValueError):
        v3.read(tmp_path / "a.vqvdb")


def test_v3_refuses_more_than_256_codes(tmp_path):
    idx = np.zeros((1, 4, 4, 4), np.uint16)
    with pytest.raises(ValueError):
        v3.write(tmp_path / "a.vqvdb", "density", np.zeros((1, 3), np.int32), idx, 512)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "vqvdb_tpu",
                                               "vqvdb_tpu_torch"), (path.name, n)
