"""The quantizer kernels' plain versions against the Pallas kernels.

On the CPU the Pallas kernels run in interpret mode, as
tests/test_pallas_quantize.py runs them. Indices must be equal (the
inputs are built with exact ties and integer-valued scores where a tie
matters); dequantized rows bit-equal, including the all-zero row of an
out-of-range index. The CUDA kernels themselves are held to these plain
versions in tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.models import quantizer as jquantizer
from vqvdb_tpu.ops import quantize as jq
from vqvdb_tpu_torch.models.quantizer import dequantize, nearest_indices
from vqvdb_tpu_torch.ops import quantize as q

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n", [555, 1024])
def test_dequantize_matches_pallas(rng, n):
    k, d = 64, 32
    cb = _rand(rng, k, d)
    idx = rng.integers(0, k, size=n).astype(np.int32)
    idx[[0, 7, n - 1]] = [200, k, 255]  # out of range -> zero rows
    ref = np.asarray(jq.fused_dequantize(jnp.asarray(idx), jnp.asarray(cb),
                                         tile_n=256, interpret=True))
    got = dequantize(torch.from_numpy(idx), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[[0, 7, n - 1]].any()
    # uint8 indices, the codec's dtype, give the same rows
    got_u8 = dequantize(torch.from_numpy(idx.astype(np.uint8)),
                        torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got_u8, ref)


def _tied_scores_inputs(rng, n, f, k):
    """h, M, c with small-integer values (exact f32 products and sums) and
    columns 9 and 200 identical, so rows tie exactly between them."""
    h = rng.integers(-3, 4, size=(n, f)).astype(np.float32)
    m = rng.integers(-3, 4, size=(f, k)).astype(np.float32)
    c = rng.integers(-40, 40, size=(1, k)).astype(np.float32)
    m[:, 200] = m[:, 9]
    c[0, 200] = c[0, 9]
    c[0, 9] = c[0, 200] = -10000.0  # the tied pair wins every row
    return h, m, c


@pytest.mark.parametrize("n", [1000, 1024])
def test_score_argmin_matches_pallas(rng, n):
    h, m, c = _tied_scores_inputs(rng, n, 64, 256)
    ref = np.asarray(jq.fused_score_argmin(jnp.asarray(h), jnp.asarray(m),
                                           jnp.asarray(c), tile_n=256,
                                           interpret=True))
    got = q.score_argmin_plain(torch.from_numpy(h), torch.from_numpy(m),
                               torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 9).all()  # first minimum of the tie
    # and a generic (tie-free) case
    h2, m2, c2 = _rand(rng, n, 64), _rand(rng, 64, 256), _rand(rng, 1, 256)
    ref = np.asarray(jq.fused_score_argmin(jnp.asarray(h2), jnp.asarray(m2),
                                           jnp.asarray(c2), tile_n=256,
                                           interpret=True))
    got = q.score_argmin_plain(torch.from_numpy(h2), torch.from_numpy(m2),
                               torch.from_numpy(c2)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_score_argmin_nan_is_first_nan(rng):
    h, m, c = _rand(rng, 64, 8), _rand(rng, 8, 64), _rand(rng, 1, 64)
    c[0, [5, 40]] = np.nan
    ref = np.asarray(jq.score_argmin_xla(jnp.asarray(h), jnp.asarray(m),
                                         jnp.asarray(c)))
    got = q.score_argmin_plain(torch.from_numpy(h), torch.from_numpy(m),
                               torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 5).all()


@pytest.mark.parametrize("n", [1000, 1024])
def test_nearest_matches_pallas(rng, n):
    d, k = 128, 256
    z, cb = _rand(rng, n, d), _rand(rng, k, d)
    ref = np.asarray(jq.fused_nearest_indices(jnp.asarray(z), jnp.asarray(cb),
                                              tile_n=256, interpret=True))
    got = nearest_indices(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(jquantizer.nearest_indices(jnp.asarray(z), jnp.asarray(cb))))


def test_nearest_tie_breaking(rng):
    d, k = 16, 64
    cb = rng.integers(-2, 3, size=(k, d)).astype(np.float32)
    cb[50] = cb[3]  # exact duplicate rows -> tie
    z = np.concatenate([cb[3][None],
                        rng.integers(-2, 3, size=(127, d)).astype(np.float32)])
    ref = np.asarray(jq.fused_nearest_indices(jnp.asarray(z), jnp.asarray(cb),
                                              tile_n=128, interpret=True))
    got = nearest_indices(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 3


def test_wrappers_on_cpu_run_plain_and_launch_nothing(rng):
    before = (q.fused_dequantize.launches, q.fused_score_argmin.launches,
              q.fused_nearest_indices.launches)
    cb = torch.from_numpy(_rand(rng, 64, 32))
    idx = torch.from_numpy(rng.integers(0, 70, size=100).astype(np.uint8))
    assert torch.equal(q.fused_dequantize(idx, cb), dequantize(idx, cb))
    h, m, c = (torch.from_numpy(a) for a in _tied_scores_inputs(rng, 100, 64, 256))
    out = q.fused_score_argmin(h, m, c)
    assert out.dtype == torch.int32
    assert torch.equal(out, q.score_argmin_plain(h, m, c))
    z = torch.from_numpy(_rand(rng, 100, 32))
    out = q.fused_nearest_indices(z, cb)
    assert out.dtype == torch.int32
    assert torch.equal(out.long(), nearest_indices(z, cb))
    assert before == (q.fused_dequantize.launches, q.fused_score_argmin.launches,
                      q.fused_nearest_indices.launches)
