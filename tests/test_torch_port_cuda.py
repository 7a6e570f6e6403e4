"""The CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a card. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

For the quantizer kernels the inputs are small integers, so every product
and sum is exact in f32 (and TF32) and indices must be equal, ties going to
the first minimum; ragged row counts and out-of-range dequantize indices are
included. The fused residual block is held to its plain version within
2e-5 in f32 (sums in another order) and within one bf16 step in bf16 (both
compute in f32 and round once at the end).
"""

import numpy as np
import pytest
import torch

from vqvdb_tpu_torch.models.quantizer import dequantize, nearest_indices
from vqvdb_tpu_torch.ops import quantize as q
from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused, residual_block_plain


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tied_scores_inputs(rng, n, f, k):
    """h, M, c of small integers with columns 9 and 200 identical and
    winning every row, so each row ties exactly between them."""
    h = rng.integers(-3, 4, size=(n, f)).astype(np.float32)
    m = rng.integers(-3, 4, size=(f, k)).astype(np.float32)
    c = rng.integers(-40, 40, size=(1, k)).astype(np.float32)
    m[:, 200] = m[:, 9]
    c[0, 9] = c[0, 200] = -10000.0
    return h, m, c


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype", [torch.uint8, torch.int32])
def test_card_dequantize(rng, dtype, idx_dtype):
    dev = _card()
    k, d, n = 64, 128, 1000
    cb = torch.from_numpy(_rand(rng, k, d)).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, k, size=n).astype(np.int64))
    idx[[0, n - 1]] = 200
    idx = idx.to(dev, idx_dtype)
    launches = q.fused_dequantize.launches
    got = q.fused_dequantize(idx, cb)
    torch.cuda.synchronize()
    assert q.fused_dequantize.launches == launches + 1
    assert torch.equal(got, dequantize(idx, cb))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_score_argmin_ties_and_ragged_rows(rng, dtype):
    dev = _card()
    h, m, c = (torch.from_numpy(a).to(dev)
               for a in _tied_scores_inputs(rng, 1000, 64, 256))
    h = h.to(dtype)  # small integers are exact in bf16
    got = q.fused_score_argmin(h, m, c)
    assert torch.equal(got, q.score_argmin_plain(h, m, c))
    assert (got == 9).all()
    c2 = c.clone()
    c2[0, [5, 40]] = float("nan")
    assert (q.fused_score_argmin(h, m, c2) == 5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 128, 256])
def test_card_nearest(rng, k):
    dev = _card()
    cb = torch.from_numpy(rng.integers(-2, 3, size=(k, 128)).astype(np.float32)).to(dev)
    cb[k - 1] = cb[3]
    z = torch.from_numpy(rng.integers(-2, 3, size=(777, 128)).astype(np.float32)).to(dev)
    z[0] = cb[3]
    got = q.fused_nearest_indices(z, cb)
    assert torch.equal(got.long(), nearest_indices(z, cb))
    assert got[0] == 3


@pytest.mark.cuda
def test_card_wrappers_raise_instead_of_falling_back(rng):
    dev = _card()
    cb = torch.from_numpy(_rand(rng, 64, 128)).to(dev)
    with pytest.raises(ValueError):  # int64 indices: no silent cast
        q.fused_dequantize(torch.zeros(8, dtype=torch.int64, device=dev), cb)
    with pytest.raises(ValueError):  # indices on the CPU, codebook on the card
        q.fused_dequantize(torch.zeros(8, dtype=torch.uint8), cb)
    h = torch.zeros(8, 64, device=dev)
    with pytest.raises(ValueError):  # K outside what the kernel takes
        q.fused_score_argmin(h, torch.zeros(64, 100, device=dev),
                             torch.zeros(1, 100, device=dev))
    with pytest.raises(ValueError):  # z must be f32 on the card
        q.fused_nearest_indices(torch.zeros(8, 128, device=dev, dtype=torch.bfloat16), cb)


def _rb_params(rng, dev, c=16):
    """A residual block's tree in the port's layout (OIDHW convs)."""
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    conv = lambda: {"w": t(0.05 * rng.standard_normal((c, c, 3, 3, 3))),
                    "b": t(0.1 * rng.standard_normal(c))}
    gn = lambda: {"scale": t(1 + 0.1 * rng.standard_normal(c)),
                  "bias": t(0.1 * rng.standard_normal(c))}
    return {"gn1": gn(), "conv1": conv(), "gn2": gn(), "conv2": conv()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [8, 4])
@pytest.mark.parametrize("n", [301, 1])
def test_card_fused_rb(rng, dtype, groups, n):
    """301 leaves: more than one pass of the persistent grid, and an odd
    count, so one block's second leaf slot runs empty."""
    dev = _card()
    p = _rb_params(rng, dev)
    x = torch.from_numpy(_rand(rng, n, 8, 8, 8, 16)).to(dev, dtype)
    launches = residual_block_fused.launches
    got = residual_block_fused(p, x, groups=groups)
    torch.cuda.synchronize()
    assert residual_block_fused.launches == launches + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = residual_block_plain(p, x, groups, 0.1)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=8e-3)
    # another residual scale, and the same input gives the same bits again
    assert torch.equal(residual_block_fused(p, x, groups=groups), got)
    half = residual_block_fused(p, x, groups=groups, res_scale=0.5)
    tol = dict(atol=5e-5, rtol=2e-5) if dtype == torch.float32 else dict(atol=1e-3, rtol=8e-3)
    torch.testing.assert_close(half.float(),
                               residual_block_plain(p, x, groups, 0.5).float(), **tol)


@pytest.mark.cuda
def test_card_fused_rb_raises_instead_of_falling_back(rng):
    dev = _card()
    p = _rb_params(rng, dev)
    x = torch.zeros(4, 8, 8, 8, 16, device=dev)
    assert residual_block_fused(p, x[:0]).shape == (0, 8, 8, 8, 16)
    with pytest.raises(ValueError):  # NCDHW memory under an NDHWC shape
        residual_block_fused(p, torch.zeros(4, 16, 8, 8, 8, device=dev).permute(0, 2, 3, 4, 1))
    with pytest.raises(ValueError):  # f16 is not taken
        residual_block_fused(p, x.half())
    with pytest.raises(ValueError):  # C != 16
        residual_block_fused(_rb_params(rng, dev, c=32), torch.zeros(4, 8, 8, 8, 32, device=dev))
    with pytest.raises(ValueError):  # input on the card, weights on the CPU
        residual_block_fused(_rb_params(rng, torch.device("cpu")), x)
    with pytest.raises(ValueError):  # groups must divide 16
        residual_block_fused(p, x, groups=3)
