"""The fused 16-channel residual block: the port's plain version (and its
wrapper on CPU tensors) against the JAX package's Pallas kernel in interpret
mode and against `blocks.residual_block`, as tests/test_fused_rb.py runs
them.

Tolerances: f32 atol = rtol = 2e-5 (two 432-term f32 conv sums and two
GroupNorms, taken in another order); bf16 atol = rtol = 3e-2 (the fused
block keeps f32 between its stages where `blocks.residual_block` rounds to
bf16, and bf16 has 8 bits of mantissa). The CUDA kernel itself is held to
the plain version in tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.models import blocks as jblocks
from vqvdb_tpu.ops.fused_rb import residual_block_fused as jax_fused
from vqvdb_tpu_torch.core.weights import tree_to_torch
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused, residual_block_plain

torch.set_num_threads(2)


def _rb_params(rng, c=16, k=3):
    """Trained-looking block weights in the JAX layout (numpy)."""
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    return {
        "gn1": {"scale": 1 + r(c, scale=0.1), "bias": r(c, scale=0.1)},
        "conv1": {"w": r(k, k, k, c, c, scale=0.05), "b": r(c, scale=0.1)},
        "gn2": {"scale": 1 + r(c, scale=0.1), "bias": r(c, scale=0.1)},
        "conv2": {"w": r(k, k, k, c, c, scale=0.05), "b": r(c, scale=0.1)},
    }


def _port(tree):
    return tree_to_torch(tree, torch.device("cpu"))


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("groups", [8, 4])
@pytest.mark.parametrize("n", [37, 1])
def test_plain_matches_pallas_and_oracle_f32(rng, groups, n):
    """37 leaves are a multiple of no tile; the Pallas kernel pads them."""
    p = _rb_params(rng)
    x = rng.standard_normal((n, 8, 8, 8, 16)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    pallas = np.asarray(jax_fused(jp, jnp.asarray(x), groups=groups, tile=16,
                                  interpret=True))
    oracle = np.asarray(jblocks.residual_block(jp, jnp.asarray(x), groups=groups))
    got = residual_block_plain(_port(p), torch.from_numpy(x), groups, 0.1)
    wrapped = residual_block_fused(_port(p), torch.from_numpy(x), groups=groups)
    assert torch.equal(got, wrapped)  # the wrapper on a CPU tensor is the plain version
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5, rtol=2e-5)
    # and the port's own eager block, which the codec runs with fuse_rb16=False
    eager = blocks.residual_block(_port(p), torch.from_numpy(x), groups=groups)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("groups", [8, 4])
def test_plain_matches_pallas_and_oracle_bf16(rng, groups):
    p = _rb_params(rng)
    x = rng.standard_normal((32, 8, 8, 8, 16)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(jax_fused(jp, xj, groups=groups, tile=32, interpret=True),
                        np.float32)
    oracle = np.asarray(jblocks.residual_block(jp, xj, groups=groups), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = residual_block_fused(_port(p), xt, groups=groups)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    # Same arithmetic as the Pallas kernel (f32 inside, bf16 weights): they
    # differ by the last bf16 rounding only.
    np.testing.assert_allclose(_f32(got), pallas, atol=1.6e-2, rtol=8e-3)
    np.testing.assert_allclose(_f32(got), oracle, atol=3e-2, rtol=3e-2)


def test_res_scale_and_empty_batch(rng):
    p = _rb_params(rng)
    x = rng.standard_normal((3, 8, 8, 8, 16)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    ref = np.asarray(jax_fused(jp, jnp.asarray(x), res_scale=0.5, tile=8,
                               interpret=True))
    got = residual_block_fused(_port(p), torch.from_numpy(x), res_scale=0.5)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=2e-5)
    empty = residual_block_fused(_port(p), torch.zeros(0, 8, 8, 8, 16))
    assert empty.shape == (0, 8, 8, 8, 16) and empty.dtype == torch.float32


def test_wrapper_counts_no_launch_on_cpu_and_raises_on_bad_input(rng):
    p = _port(_rb_params(rng))
    before = residual_block_fused.launches
    residual_block_fused(p, torch.zeros(2, 8, 8, 8, 16))
    assert residual_block_fused.launches == before
    with pytest.raises(ValueError):  # C != 16
        residual_block_fused(_port(_rb_params(rng, c=32)), torch.zeros(2, 8, 8, 8, 32))
    with pytest.raises(ValueError):  # not a leaf
        residual_block_fused(p, torch.zeros(2, 4, 4, 4, 16))
    with pytest.raises(ValueError):  # f16 is not taken
        residual_block_fused(p, torch.zeros(2, 8, 8, 8, 16, dtype=torch.float16))
    with pytest.raises(ValueError):  # groups must divide 16
        residual_block_fused(p, torch.zeros(2, 8, 8, 8, 16), groups=3)
    with pytest.raises(ValueError):  # a pointwise closer is another block
        residual_block_fused(_port(_rb_params(rng, k=1)), torch.zeros(2, 8, 8, 8, 16))
