"""upstream's scalar model at its published widths (`configs/scalar_reference.json`,
`models/scalar_reference.vqmodel`: EncoderFloat, D 128, K 256) on the CPU: the
port's encode against the plain reference on seeded random weights at those
widths, the committed configuration and its tiny cell, and the fused residual
block's roofline (`counts/fused_rb.py`, `metrics/fused_rb_roofline.py`)."""

import json
import re

import numpy as np
import pytest
import torch

from portbench import checks, harness
from portbench.counts import flops, fused_rb, kernels
from portbench.harness import Record
from portbench.reference import reference, v3, vqmodel
from portbench.tests.conftest import run_tiny, tiny_cell

CELL = "scalar_reference.encode_frames"
CONFIG = json.loads((harness.BENCH / "configs" / "scalar_reference.json").read_text())
LIMITS = json.loads((harness.BENCH / "limits" / f"{CELL}.json").read_text())["limits"]
MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
PEAKS = json.loads((harness.BENCH / "counts" / "peaks.json").read_text())["cards"]["H100"]
CSRC = harness.ROOT / "vqvdb_tpu_torch" / "csrc"
KERNEL = "rb16_tc_kernel"
LEAVES = 48  # three codec batches of 16


def _draw(path, seed):
    """Seeded random weights at EncoderFloat's widths, written as an artifact."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.models.vqvae import init_vqvae_params

    cfg = ModelConfig(in_channels=1, embedding_dim=128, num_embeddings=256,
                      encoder_arch="reference")
    save_model(path, init_vqvae_params(torch.Generator().manual_seed(seed), cfg), cfg)
    return path


def _leaves(seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (LEAVES, 8, 8, 8, 1)).astype(np.float32)


def _codec_indices(path, leaves, dtype, tmp_path):
    """The leaves through `VQCodec.compress` to a v3 file, read back by the
    frozen v3 reader."""
    from vqvdb_tpu_torch.api import make_codec
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    origins = (np.stack(np.unravel_index(np.arange(LEAVES), (4, 4, 3)), 1) * 8).astype(np.int32)
    out = tmp_path / f"{dtype}.vqvdb"
    make_codec(path, batch_size=16, compute_dtype=dtype, device="cpu").compress(
        LeafGrid("density", origins, leaves), out, format_version=3)
    _, ((name, o, idx),) = v3.read(out)
    assert name == "density" and np.array_equal(o, origins)
    return origins, idx


def _numbers(model, leaves, origins, indices, control=None):
    tally = checks.Tally("encode")
    checks.encode_frame(tally, model, leaves, origins, origins, indices, torch.device("cpu"),
                        control=control)
    return tally.numbers()


def test_drawn_weights_have_encoderfloats_widths(tmp_path):
    params, cfg = vqmodel.load(_draw(tmp_path / "m.vqmodel", 1))
    assert reference.sizes(params, cfg) == CONFIG["sizes"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_ports_encode_matches_the_reference_in_f32(tmp_path, seed):
    """In f32 the port and the reference sum in different orders, so a row
    whose two nearest codes lie within the sums' rounding may differ: all
    but 1% agree (every row did on these seeds)."""
    path = _draw(tmp_path / "m.vqmodel", seed)
    params, cfg = vqmodel.load(path)
    leaves = _leaves(seed)
    _, got = _codec_indices(path, leaves, "float32", tmp_path)
    want = reference.Model(params, cfg, torch.device("cpu")).encode(torch.from_numpy(leaves))
    assert got.shape == tuple(want.shape) == (LEAVES, 4, 4, 4)
    assert (got != want.numpy()).mean() <= 0.01


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_bf16_codec_holds_the_encode_checks_limits(tmp_path, seed):
    """The bf16 codec judged as the cell judges it: within the committed
    limits, and its regret under a tenth of the fp8 control's on the same
    weights and leaves (bf16 keeps 8 bits of mantissa where e4m3 keeps 3;
    the codec read 1.3e-6 to 3.1e-6 against the control's 4.7e-4 to 7.6e-4)."""
    path = _draw(tmp_path / "m.vqmodel", seed)
    params, cfg = vqmodel.load(path)
    model = reference.Model(params, cfg, torch.device("cpu"))
    leaves = _leaves(seed)
    origins, got = _codec_indices(path, leaves, "bfloat16", tmp_path)
    mine = _numbers(model, leaves, origins, got)
    ok, rows = checks.judge(mine, LIMITS)
    assert ok, rows
    control = _numbers(model, leaves, origins, got,
                       control=reference.Model(params, cfg, torch.device("cpu"), "fp8"))
    assert 0 < mine["regret_share"] < control["regret_share"] / 10


def test_the_committed_configuration_is_the_artifacts():
    cell = harness.load_cell(CELL)
    params, cfg = vqmodel.load(harness.ROOT / CONFIG["model"])
    assert cell.config == CONFIG and CONFIG["model"] == "models/scalar_reference.vqmodel"
    assert flops.sizes_from_params(params, cfg, "reference") == CONFIG["sizes"]
    assert CONFIG["reduced"] == [] and CONFIG["reference"] == "reference"
    assert CONFIG["codec"] == {"batch_size": 4096, "compute_dtype": "bfloat16"}
    assert flops.flops_per_leaf(CONFIG["sizes"], "encode", "reference") == 30_589_952
    entry = next(c for c in MANIFEST["configs"] if c["name"] == "scalar_reference")
    assert entry["source"] == CONFIG["source"] and entry["reduced"] == []
    work = next(w for w in MANIFEST["workloads"] if w["name"] == CELL)
    assert (work["config"], work["traffic"], work["chips"]) == ("scalar_reference",
                                                                "frames-encode", 1)
    assert cell.traffic == harness.load_cell("scalar.encode_frames").traffic
    # the cell reports what cell 3 reports, the 8^3 stage and the fused block
    want = {m["name"] for m in harness.load_cell("scalar.encode_frames").per_layer}
    assert {m["name"] for m in cell.per_layer} == want | {"fine_grid_ms_per_batch.encode",
                                                          "fused_rb_roofline"}
    assert set(LIMITS) == {"origins_off", "index_mismatch_share", "regret_share",
                           "leaf_regret_max"} and LIMITS["origins_off"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_runs_correct(trace):
    """Untraced, the line holds the end-to-end metrics; traced on the CPU,
    the per-layer ones but those only a card can give (the 8^3 stage's
    device time and the fused block's roofline)."""
    result = run_tiny(tiny_cell(CELL), seconds=2.0, trace=trace)
    assert result["correct"] and result["failed"] == 0, result["check"]
    if trace:
        assert "stage_in_ms_per_batch.encode" in result["metrics"]
        assert not {"fine_grid_ms_per_batch.encode", "fused_rb_roofline"} & set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"encode_leaves_per_s", "setup_s"}


def test_the_tiny_cell_with_one_code_a_batch_shifted_reads_incorrect(monkeypatch):
    """The first code of each batch the codec writes moved to the next
    codeword: `correct` is false."""
    from vqvdb_tpu_torch.format.vqvdb import VqvdbWriter

    write = VqvdbWriter.write_batch

    def write_batch(self, indices, origins, *rest):
        idx = np.array(indices, copy=True)
        flat = idx.reshape(-1)
        flat[0] = (int(flat[0]) + 1) % self._shared_num_embeddings
        return write(self, idx, origins, *rest)
    monkeypatch.setattr(VqvdbWriter, "write_batch", write_batch)
    result = run_tiny(tiny_cell(CELL))
    assert result["failed"] == 0 and result["correct"] is False, result["check"]
    assert result["check"]["leaf_regret_max"]["value"] > LIMITS["leaf_regret_max"]


@pytest.mark.parametrize("value_bytes", [2, 4])
def test_the_fused_block_count_by_hand(value_bytes):
    conv = 2 * 512 * 27 * 16 * 16            # one k3 16 -> 16 conv over the 8^3 voxels
    weights = 2 * 27 * 16 * 16 * 4          # both convs' f32 weights, once a launch
    rows = 6 * 16 * 4                        # gn1, conv1 bias, gn2, conv2 bias rows in f32
    assert 2 * conv == 14_155_776 and weights + rows == 55_680
    leaf = 2 * 512 * 16 * value_bytes        # a leaf read once and written once
    assert leaf == {2: 32_768, 4: 65_536}[value_bytes]
    assert fused_rb.residual_block(1, 0, 16, value_bytes) == (leaf, 14_155_776)
    assert fused_rb.residual_block(4096, 3, 16, value_bytes) == (4096 * leaf + 3 * 55_680,
                                                                 4096 * 14_155_776)


def test_the_fused_block_is_operations_bound_at_a_batch():
    nbytes, ops = fused_rb.residual_block(4096, 1)
    least, by = kernels.bound_seconds(nbytes, ops, PEAKS)
    # 57.98 GFLOP at 989 TFLOP/s against 134.3 MB at 3.35 TB/s (40.1 us)
    assert by == "operations" and least == pytest.approx(58.63e-6, rel=1e-3)
    assert nbytes / PEAKS["hbm_bytes_per_s"] == pytest.approx(40.08e-6, rel=1e-3)


def _traced(direction="encode", kernel_names=(KERNEL,), batches=18, ms=0.3975):
    """A record of a traced window of `batches` full batches, each with one
    launch of every kernel named, `ms` of device time each."""
    rec = Record(direction=direction, chips=1, sizes=CONFIG["sizes"], value_bytes=2,
                 peaks=PEAKS, leaves=4096 * batches, batches=batches)
    rec.trace = {"kernels": {f"void {k}<__nv_bfloat16>(__nv_bfloat16 const*, float*)":
                             {"seconds": batches * ms * 1e-3, "launches": batches}
                             for k in kernel_names},
                 "window_s": 1.0, "busy_s": 0.5}
    return rec


def test_the_reader_gives_the_kernels_share():
    read = harness.metric_reader("fused_rb_roofline")
    rec = _traced(kernel_names=(KERNEL, "score_argmin_kernel", "group_norm_relu_kernel"))
    got = read(rec)
    # 0.05863 ms of operations a batch against 0.3975 ms a batch
    assert got == pytest.approx(100 * 58.63e-3 / 0.3975, rel=1e-3)
    assert 0 < got <= 100 and rec.bounds[KERNEL] == "operations"


@pytest.mark.parametrize("case", ["decode", "no_kernel", "untraced", "off_the_card"])
def test_the_reader_finds_nothing_to_read(case):
    rec = _traced(direction="decode" if case == "decode" else "encode",
                  kernel_names=("score_argmin_kernel",) if case == "no_kernel" else (KERNEL,))
    if case == "untraced":
        rec.trace = None
    if case == "off_the_card":
        rec.peaks = None
    assert harness.metric_reader("fused_rb_roofline")(rec) is None


def test_the_pattern_names_one_kernel_of_the_port():
    """Of the `__global__` functions of the port's CUDA sources (its six
    kernels: dequantize, score-argmin and nearest-indices, the fused block,
    GroupNorm, the decoder head's pair), only the fused block's holds the
    pattern."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                               src.read_text()):
            found[name] = src.name
    assert {"dequantize_kernel", "score_argmin_kernel", KERNEL, "group_norm_relu_kernel",
            "gate_kernel", "head_kernel"} <= set(found)
    assert [n for n in found if KERNEL in n] == [KERNEL] and found[KERNEL] == "fused_rb_tc.cu"
