"""The benchmark's operation and byte counts, pinned to a hand derivation."""

import json
from pathlib import Path

import pytest

from portbench.counts import flops, kernels
from portbench.reference import vqmodel

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _sizes(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["sizes"]


def test_flagship_decoder_flops_by_hand():
    # 64 latent positions; a k3 conv is 27 taps; a multiply-add is 2.
    stem = 2 * 64 * 27 * 128 * 64          # conv k3 D=128 -> 64
    block = 2 * (2 * 64 * 27 * 64 * 64)    # the residual block's two k3 64 -> 64 convs
    attention = 2 * (2 * 64 * 16)          # fc1 64 -> 16, fc2 16 -> 64
    up = 2 * 64 * 27 * 64 * 256            # up_conv k3 64 -> 256
    final = 2 * 512 * 27 * 32 * 1          # final conv k3 32 -> 1 over the 8^3 voxels
    assert stem + block + attention + up + final == 114_135_040
    assert flops.flops_per_leaf(_sizes("scalar"), "decode") == 114_135_040
    # bench.py's 61.0 MFLOP counts the folded graph: up_conv, the shuffle
    # and the final conv as one 4096 x 512 GEMM (57.5 MFLOP of the plain
    # tail become 4.2), the attention as ~0.1M, and rounds up.
    assert round((stem + block + attention + 2 * 4096 * 512) / 1e6, 1) == 60.8


def test_flagship_encoder_flops_by_hand():
    stem = 2 * 64 * 27 * 8 * 64            # conv k3 on the packed grid, 8 -> 64
    block = 2 * (2 * 64 * 27 * 64 * 64)
    attention = 2 * (2 * 64 * 16)
    proj = 2 * 64 * 64 * 128               # 1x1 64 -> D
    distances = 2 * 64 * 256 * 128         # each latent row against K = 256 codes
    assert stem + block + attention + proj + distances == 35_328_000
    assert flops.flops_per_leaf(_sizes("scalar"), "encode") == 35_328_000
    # bench.py's 32.2 folds proj and the distances into one F=64 x K=256 product.
    assert round((stem + block + attention + 2 * 64 * 64 * 256) / 1e6, 1) == 32.2


def test_vec3_flops():
    s = _sizes("vec3")
    conv = 2 * 64 * 27 * 128 * 128
    assert flops.flops_per_leaf(s, "decode") == (
        conv + 4 * conv + 2 * (2 * 128 * 32) + 2 * 64 * 27 * 128 * 256 + 2 * 512 * 27 * 32 * 3)
    assert flops.flops_per_leaf(s, "encode") == (
        2 * 64 * 27 * 24 * 128 + 2 * conv + 2 * (2 * 128 * 32) + 2 * 64 * 128 * 128
        + 2 * 64 * 256 * 128)


@pytest.mark.parametrize("name", ["scalar", "vec3"])
def test_config_sizes_are_the_artifacts(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    params, model_cfg = vqmodel.load(ROOT / cfg["model"])
    assert flops.sizes_from_params(params, model_cfg) == cfg["sizes"]


def test_kernel_counts_of_a_flagship_batch():
    peaks = json.loads((BENCH / "counts" / "peaks.json").read_text())["cards"]["H100"]
    rows = 4096 * 64
    nbytes, ops = kernels.dequantize(rows, 1, 256, 128)
    assert nbytes == rows + 256 * 128 * 2 + rows * 128 * 2 == 67_436_544 and ops == 0
    least, by = kernels.bound_seconds(nbytes, ops, peaks)
    assert by == "bytes" and least == pytest.approx(20.13e-6, rel=1e-3)
    nbytes, ops = kernels.score_argmin(rows, 1, 64, 256)
    assert nbytes == rows * 64 * 2 + (64 * 256 + 256) * 4 + rows == 33_883_136
    assert ops == 2 * rows * 64 * 256 == 8_589_934_592
    least, by = kernels.bound_seconds(nbytes, ops, peaks)
    # 10.11 us of bytes against 8.69 us of operations: bytes bound it.
    assert by == "bytes" and least == pytest.approx(10.114e-6, rel=1e-3)
