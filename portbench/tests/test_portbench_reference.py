"""The plain reference against the port, at a tiny size on the CPU, and its
frozen readers and writer against the port's.

The reference imports nothing of the port; these tests import both."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import layers, packed, v3, vqmodel

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MODELS = ["scalar", "vec3"]


def _codec(name, **kw):
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    params, cfg = load_model(ROOT / "models" / f"{name}.vqmodel")
    return VQCodec(params, cfg, CodecConfig(batch_size=32, **kw), device="cpu")


def _reference(name, rounding="float32"):
    params, cfg = vqmodel.load(ROOT / "models" / f"{name}.vqmodel")
    return packed.Model(params, cfg, torch.device("cpu"), rounding)


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_the_port_in_f32(name):
    idx = np.random.default_rng(1).integers(0, 256, (40, 4, 4, 4)).astype(np.uint8)
    got = _codec(name, compute_dtype="float32").decode_indices(idx)
    ref = _reference(name).decode(torch.from_numpy(idx)).numpy()
    # Both f32: the port folds the tail into one GEMM, so the sums differ
    # in their order only (~1e-6 of leaves in [-1, 1]).
    assert np.abs(got - ref).max() < 2e-5


@pytest.mark.parametrize("name", MODELS)
def test_encode_matches_the_port_in_f32(name):
    c = 1 if name == "scalar" else 3
    leaves = np.random.default_rng(2).random((40, 8, 8, 8, c)).astype(np.float32)
    got = _codec(name, compute_dtype="float32").encode_leaves(leaves)
    ref = _reference(name).encode(torch.from_numpy(leaves)).numpy()
    assert (got != ref).mean() < 0.01


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


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "vqvdb_tpu",
                                               "vqvdb_tpu_torch"), (path.name, n)
