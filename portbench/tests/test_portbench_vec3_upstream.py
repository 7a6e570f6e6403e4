"""upstream's vec3 model at its published widths (`configs/vec3_upstream.json`,
`models/vec3_upstream.vqmodel`: EncoderVec3 / DecoderVec3, D 64, K 4,096)
on the CPU: the artifact is its recipe, the port's encode agrees with the
plain reference in f32, a v4 file keeps its u16 indices, the tiny cell runs
correct, and the 8^3 stage's device time is read only where a card timed it."""

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.harness import Record
from portbench.reference import reference, v4, vqmodel
from portbench.tests.conftest import run_tiny, tiny_cell

CELL = "vec3_upstream.encode_frames"
CONFIG = json.loads((harness.BENCH / "configs" / "vec3_upstream.json").read_text())
ARTIFACT = harness.ROOT / CONFIG["model"]
SEED = 4096  # the generator's seed of the artifact's weights


def draw_artifact(path):
    """The artifact's recipe: the port's initialiser at upstream's widths,
    from a CPU generator seeded with SEED, written by the port's writer."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.models.vqvae import init_vqvae_params

    cfg = ModelConfig(in_channels=3, embedding_dim=64, num_embeddings=4096,
                      encoder_arch="reference")
    save_model(path, init_vqvae_params(torch.Generator().manual_seed(SEED), cfg), cfg)


def _leaves(n, seed=2):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 8, 8, 8, 3)).astype(np.float32)


def _codec(**kw):
    from vqvdb_tpu_torch.api import make_codec

    return make_codec(ARTIFACT, batch_size=16, compute_dtype="float32", device="cpu", **kw)


def _reference_indices(leaves):
    params, cfg = vqmodel.load(ARTIFACT)
    model = reference.Model(params, cfg, torch.device("cpu"))
    return model.encode(torch.from_numpy(leaves)).numpy()


def test_the_artifact_is_its_recipe(tmp_path):
    draw_artifact(tmp_path / "a.vqmodel")
    made = (tmp_path / "a.vqmodel").read_bytes()
    assert made == ARTIFACT.read_bytes()
    assert hashlib.sha256(made).hexdigest() in CONFIG["assumed"]["weights"]


def test_the_artifact_has_the_configured_sizes_and_nothing_cut():
    params, cfg = vqmodel.load(ARTIFACT)
    assert reference.sizes(params, cfg) == CONFIG["sizes"]
    assert CONFIG["reduced"] == [] and CONFIG["reference"] == "reference"
    assert reference.encoder_flops(CONFIG["sizes"]) == 521_224_192


@pytest.mark.parametrize("entry", ["encode_to_indices", "encode_leaves", "compress"])
def test_the_ports_encode_matches_the_reference_in_f32(entry, tmp_path):
    """40 seeded leaves (three batches of 16) through the port, f32 on the
    CPU, against the plain EncoderVec3 and its nearest codes: all but the
    rare row whose two nearest codes lie within the sums' rounding agree."""
    leaves = _leaves(40)
    if entry == "encode_to_indices":
        from vqvdb_tpu_torch.core.artifact import load_model
        from vqvdb_tpu_torch.core.weights import params_from_jax
        from vqvdb_tpu_torch.models.vqvae import encode_to_indices

        tree, cfg = load_model(ARTIFACT)
        with torch.inference_mode():
            got = encode_to_indices(params_from_jax(tree, cfg, "cpu"),
                                    torch.from_numpy(leaves), cfg).numpy()
    elif entry == "encode_leaves":
        got = _codec().encode_leaves(leaves)
    else:
        from vqvdb_tpu_torch.vdb.grid import LeafGrid

        origins = (np.stack(np.unravel_index(np.arange(40), (4, 4, 4)), 1) * 8).astype(np.int32)
        _codec().compress(LeafGrid("velocity", origins, leaves), tmp_path / "f.vqvdb",
                          format_version=4)
        _, ((_, o, got),) = v4.read(tmp_path / "f.vqvdb")
        assert np.array_equal(o, origins)
    want = _reference_indices(leaves)
    assert got.dtype == np.uint16 and got.shape == want.shape == (40, 4, 4, 4)
    assert want.max() > 255
    assert (got != want).mean() < 0.01


def test_a_v4_files_u16_indices_survive_the_round_trip(tmp_path):
    """The codec's v4 file holds u16 indices above 255, read back equal by
    the port's reader and the frozen v4 reader, and decompressed as
    `decode_indices` decodes them."""
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    leaves = _leaves(40, seed=5)
    origins = (np.stack(np.unravel_index(np.arange(40), (4, 4, 4)), 1) * 8).astype(np.int32)
    codec = _codec()
    want = codec.encode_leaves(leaves)
    path = tmp_path / "f.vqvdb"
    codec.compress(LeafGrid("velocity", origins, leaves), path, format_version=4)
    k, ((name, o, frozen),) = v4.read(path)
    with VqvdbReader(path) as r:
        _, port, port_o = r.read_grid()
    assert (k, name, r.version) == (4096, "velocity", 4)
    for idx in (frozen, port):
        assert idx.dtype == np.uint16 and np.array_equal(idx, want)
    assert want.max() > 255 and np.array_equal(port_o, origins)
    (grid,), _ = codec.decompress(path)
    assert np.array_equal(grid.leaves, codec.decode_indices(want))


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_runs_correct(trace):
    """Untraced, the line holds the end-to-end metrics; traced on the CPU,
    the per-layer ones but the 8^3 stage's, which only a card times."""
    result = run_tiny(tiny_cell(CELL), seconds=3.0, trace=trace)
    assert result["correct"], result["check"]
    assert result["check"]["index_mismatch_share"]["value"] < 0.05
    if trace:
        assert "stage_in_ms_per_batch.encode" in result["metrics"]
        assert "fine_grid_ms_per_batch.encode" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"encode_leaves_per_s", "setup_s"}


def test_the_fine_stage_reader():
    read = harness.metric_reader("fine_grid_ms_per_batch.encode")
    rec = Record(direction="encode", chips=1, sizes=CONFIG["sizes"], value_bytes=2, peaks=None)
    assert read(rec) is None  # the parent's program, or a run off the card
    rec.stages = {"device/encode_fine": {"total_s": 0.06, "count": 12, "mean_ms": 5.0}}
    assert read(rec) == pytest.approx(5.0)
    rec.direction = "decode"
    assert read(rec) is None
