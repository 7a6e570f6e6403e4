"""The benchmark's operation and byte counts, pinned to a hand derivation."""

import json
from pathlib import Path

import pytest
import torch

from portbench.counts import flops, kernels
from portbench.reference import packed, reference, vqmodel

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
    assert flops.flops_per_leaf(_sizes("scalar"), "decode", "packed") == 114_135_040
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
    assert flops.flops_per_leaf(_sizes("scalar"), "encode", "packed") == 35_328_000
    # bench.py's 32.2 folds proj and the distances into one F=64 x K=256 product.
    assert round((stem + block + attention + 2 * 64 * 64 * 256) / 1e6, 1) == 32.2


def test_vec3_flops():
    s = _sizes("vec3")
    conv = 2 * 64 * 27 * 128 * 128
    assert flops.flops_per_leaf(s, "decode", "packed") == (
        conv + 4 * conv + 2 * (2 * 128 * 32) + 2 * 64 * 27 * 128 * 256 + 2 * 512 * 27 * 32 * 3)
    assert flops.flops_per_leaf(s, "encode", "packed") == (
        2 * 64 * 27 * 24 * 128 + 2 * conv + 2 * (2 * 128 * 32) + 2 * 64 * 128 * 128
        + 2 * 64 * 256 * 128)


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "configs").glob("*.json")))
def test_config_sizes_are_the_artifacts(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    params, model_cfg = vqmodel.load(ROOT / cfg["model"])
    assert flops.sizes_from_params(params, model_cfg, cfg["reference"]) == cfg["sizes"]


def test_packed_sizes_are_todays():
    # The sizes the harness checked the configurations against before each
    # reference module read its own: the same keys and numbers.
    for name, width in (("scalar", 64), ("vec3", 128)):
        params, model_cfg = vqmodel.load(ROOT / "models" / f"{name}.vqmodel")
        got = packed.sizes(params, model_cfg)
        assert got == _sizes(name) and got["encoder_width"] == width
        assert set(got) == {"in_channels", "embedding_dim", "num_embeddings", "encoder_width",
                            "closer_kernel", "decoder_width", "decoder_blocks",
                            "attention_reduction", "shuffle_channels"}
    params, model_cfg = vqmodel.load(ROOT / "models" / "scalar_packed_lite.vqmodel")
    assert packed.sizes(params, model_cfg)["closer_kernel"] == 1


def test_scalar_reference_encoder_flops_by_hand():
    # upstream's EncoderFloat, models/scalar_reference.vqmodel (D 128, K 256)
    params, model_cfg = vqmodel.load(ROOT / "models" / "scalar_reference.vqmodel")
    s = reference.sizes(params, model_cfg)
    assert s == {"in_channels": 1, "embedding_dim": 128, "num_embeddings": 256,
                 "decoder_width": 64, "decoder_blocks": 1, "attention_reduction": 4,
                 "shuffle_channels": 32, "pre_width": 16, "down_kernel": 4,
                 "encoder_width": 32, "encoder_blocks": 1}
    pre = 2 * 512 * 27 * 1 * 16             # conv k3 1 -> 16 over the 8^3 voxels
    pre_rb = 2 * (2 * 512 * 27 * 16 * 16)   # RB(16) over the 8^3 voxels
    down = 2 * 64 * 64 * 16 * 32            # conv k4 s2 16 -> 32, 64 outputs of 4^3 taps
    rb = 2 * (2 * 64 * 27 * 32 * 32)        # RB(32) on the 4^3 grid
    attention = 2 * (2 * 32 * 8)            # fc1 32 -> 8, fc2 8 -> 32
    proj = 2 * 64 * 32 * 128                # 1x1 32 -> D
    dist = 2 * 64 * 256 * 128               # each latent row against K = 256 codes
    assert pre + pre_rb + down + rb + attention + proj + dist == 30_589_952
    assert flops.flops_per_leaf(s, "encode", "reference") == 30_589_952
    assert flops.flops_per_leaf(s, "decode", "reference") == 114_135_040  # DecoderFloat's


def test_vec3_reference_encoder_flops_by_hand(tmp_path):
    # upstream's EncoderVec3 at the notebook's widths (D 64, K 4,096), drawn
    # with the port's initialiser and written as an artifact
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.models.vqvae import init_vqvae_params

    cfg = ModelConfig(in_channels=3, embedding_dim=64, num_embeddings=4096,
                      encoder_arch="reference")
    save_model(tmp_path / "m.vqmodel", init_vqvae_params(torch.Generator().manual_seed(3), cfg), cfg)
    params, model_cfg = vqmodel.load(tmp_path / "m.vqmodel")
    s = reference.sizes(params, model_cfg)
    assert (s["pre_width"], s["down_kernel"], s["encoder_width"], s["encoder_blocks"]) == (64, 3, 128, 2)
    pre = 2 * 512 * 27 * 3 * 64
    pre_rb = 2 * (2 * 512 * 27 * 64 * 64)   # RB(64) at 8^3: 226 M
    down = 2 * 64 * 27 * 64 * 128           # conv k3 s2 64 -> 128
    rbs = 2 * 2 * (2 * 64 * 27 * 128 * 128)
    attention = 2 * (2 * 128 * 32)
    proj = 2 * 64 * 128 * 64
    dist = 2 * 64 * 4096 * 64
    assert pre_rb == 226_492_416
    assert pre + pre_rb + down + rbs + attention + proj + dist == 521_224_192
    assert reference.encoder_flops(s) == 521_224_192


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


@pytest.mark.parametrize("k,nbytes", [(256, 1), (257, 2), (4096, 2), (65536, 2)])
def test_an_index_takes_two_bytes_beyond_256_codes(k, nbytes):
    rows = 4096 * 64
    assert kernels.dequantize(rows, 1, k, 64)[0] == rows * nbytes + k * 64 * 2 + rows * 64 * 2
    assert kernels.score_argmin(rows, 1, 128, k)[0] == rows * 128 * 2 + (128 * k + k) * 4 + rows * nbytes
