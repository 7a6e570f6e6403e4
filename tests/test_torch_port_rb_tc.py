"""The tensor-core residual block's arithmetic and operand layout, on the CPU.

`csrc/fused_rb_tc.cu` runs both 3x3x3 convs of the block as bf16 MMAs on
split f32 values. What it computes is repeated here without a card:

  * `residual_block_split_plain` (the kernel's products, term by term, f32
    sums) against the Pallas kernel in interpret mode and against
    `residual_block_plain`, with the tolerances of
    tests/test_torch_port_fused_rb.py: f32 atol = rtol = 2e-5 (two 432-term
    f32 conv sums and two GroupNorms in another order); bf16 atol 1.6e-2,
    rtol 8e-3 against Pallas and 3e-2 against the eager block, and within one
    bf16 step (atol 1e-3, rtol 8e-3) of `residual_block_plain`, which rounds
    at the same single place.
  * x with NaN and +-inf planted: the leaf that holds one is NaN in every
    version (its GroupNorm statistics are), the other leaves agree as above.
  * a numpy emulation of one team of four warps running one conv: the
    weight fragments as each block stages them, every lane's ldmatrix row
    address (tap shift, swizzle, zero rows), the fragments each thread gets,
    the mma.sync products tap by tap, and the accumulators mapped back to
    (voxel, channel); held to the dense conv of the same terms. It also
    checks that every ldmatrix phase and every plane store hits distinct
    banks, and the five-operation finite test on all bf16 patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvdb_tpu.models import blocks as jblocks
from vqvdb_tpu.ops.fused_rb import residual_block_fused as jax_fused
from vqvdb_tpu_torch.core.weights import tree_to_torch
from vqvdb_tpu_torch.ops import fused_rb as rb
from vqvdb_tpu_torch.ops.quantize import split_bf16

torch.set_num_threads(2)

# Shared-memory geometry of csrc/fused_rb_tc.cu (bytes). Every region starts
# on a 128-byte boundary: the weight fragments take 2 * 27 * terms * 512 B,
# the zero region 128 B, a team 3 planes + 512 B of GroupNorm scratch.
SLAB_BYTES = 64 * 16 * 2
PLANE_BYTES = 8 * SLAB_BYTES


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


# ---------------------------------------------------------------------------
# (a) the split products against the Pallas kernel and the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [8, 4])
@pytest.mark.parametrize("n", [37, 1])
def test_split_plain_matches_pallas_and_plain_f32(rng, groups, n):
    p = _rb_params(rng)
    x = rng.standard_normal((n, 8, 8, 8, 16)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    pallas = np.asarray(jax_fused(jp, jnp.asarray(x), groups=groups, tile=16,
                                  interpret=True))
    got = rb.residual_block_split_plain(_port(p), torch.from_numpy(x), groups, 0.1)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5, rtol=2e-5)
    plain = rb.residual_block_plain(_port(p), torch.from_numpy(x), groups, 0.1)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("groups", [8, 4])
@pytest.mark.parametrize("n", [37, 1])
def test_split_plain_matches_pallas_and_plain_bf16(rng, groups, n):
    p = _rb_params(rng)
    x = rng.standard_normal((n, 8, 8, 8, 16)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(jax_fused(jp, xj, groups=groups, tile=16, interpret=True),
                        np.float32)
    oracle = np.asarray(jblocks.residual_block(jp, xj, groups=groups), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = rb.residual_block_split_plain(_port(p), xt, groups, 0.1)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=1.6e-2, rtol=8e-3)
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=3e-2, rtol=3e-2)
    plain = rb.residual_block_plain(_port(p), xt, groups, 0.1)
    torch.testing.assert_close(got.float(), plain.float(), atol=1e-3, rtol=8e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [8, 4])
def test_split_plain_non_finite_leaves(rng, dtype, groups):
    p = _port(_rb_params(rng))
    x = rng.standard_normal((6, 8, 8, 8, 16)).astype(np.float32)
    x[1, 2, 3, 4, 5] = np.nan
    x[3, 7, 0, 0, 15] = np.inf
    x[4, 0, 7, 1, 0] = -np.inf
    x[4, 5, 5, 5, 6] = np.inf
    xt = torch.from_numpy(x).to(dtype)
    got = rb.residual_block_split_plain(p, xt, groups, 0.1).float()
    want = rb.residual_block_plain(p, xt, groups, 0.1).float()
    bad = [1, 3, 4]
    assert torch.isnan(got[bad]).all() and torch.isnan(want[bad]).all()
    good = [0, 2, 5]
    assert torch.isfinite(got[good]).all()
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 else dict(atol=1e-3, rtol=8e-3)
    torch.testing.assert_close(got[good], want[good], **tol)


# ---------------------------------------------------------------------------
# (b) one team's conv, emulated
# ---------------------------------------------------------------------------

def _unit(v, hf):
    """16-byte unit of half hf (channels 8 hf .. 8 hf + 7) of voxel v in a plane."""
    return 2 * v + (hf ^ ((v >> 2) & 1))


def _voxel(d, warp, rr, g):
    """The voxel of accumulator row g + 8 rr of warp `warp` in slab d."""
    return d * 64 + (2 * warp + rr) * 8 + g


def _store_planes(terms):
    """terms [3, 512, 16] -> the team's planes [3, PLANE_BYTES / 2] (bf16
    elements), written as gn_relu_store writes them: thread (warp, lane =
    4 g + t) stores the pair of channels 8 nh + 2 t, + 1 of voxel
    (d, 2 warp + rr, g) to byte 16 unit(v, nh) + 4 t of each plane. Checks
    that every word is written once and that each store instruction's 32
    words fall in 32 distinct banks."""
    planes = np.full((3, PLANE_BYTES // 2), np.nan)
    writes = np.zeros((3, PLANE_BYTES // 4), int)
    for warp in range(4):
        for d in range(8):
            for rr in range(2):
                for nh in range(2):
                    banks = set()
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        v = _voxel(d, warp, rr, g)
                        byte = 16 * (2 * v + (nh ^ ((g >> 2) & 1))) + 4 * t
                        assert byte == 16 * _unit(v, nh) + 4 * t
                        planes[:, byte // 2: byte // 2 + 2] = terms[:, v, 8 * nh + 2 * t: 8 * nh + 2 * t + 2]
                        writes[:, byte // 4] += 1
                        banks.add((byte // 4) % 32)
                    assert len(banks) == 32
    assert (writes == 1).all()
    return planes


def _stage_weights(w_terms):
    """w_terms [P, 2 convs, 27 taps, 16 in, 16 out] -> the block's weight
    fragments [2, 27, P, 32 lanes, 4 words, 2 (low, high half)], by the
    kernel's stage_weights index arithmetic."""
    n_terms = w_terms.shape[0]
    wsm = np.full((2, 27, n_terms, 32, 4, 2), np.nan)
    for i in range(2 * 27 * 32 * 4):
        j, lane, tap, conv = i & 3, (i >> 2) & 31, (i >> 7) % 27, (i >> 7) // 27
        ci, co = 2 * (lane & 3) + 8 * (j & 1), 8 * (j >> 1) + (lane >> 2)
        wsm[conv, tap, :, lane, j] = w_terms[:, conv, tap, ci: ci + 2, co]
    return wsm


def _lane_address(warp, lane, kh, kw, din, plane):
    """("plane" or "zero", byte) of a lane's ldmatrix row, as conv3x3x3
    computes it."""
    row, hf = lane & 15, lane >> 4
    h, w = 2 * warp + (row >> 3) + kh - 1, (row & 7) + kw - 1
    unit = _unit(8 * h + w, hf)
    if 0 <= h < 8 and 0 <= w < 8:
        return "plane", plane * PLANE_BYTES + din * SLAB_BYTES + 16 * unit
    return "zero", 16 * (unit & 7)


def _ldmatrix_x4(planes, warp, kh, kw, din, plane):
    """regs [32 lanes, 4, 2]: lanes 8 j .. 8 j + 7 give the rows of matrix j;
    lane l receives, of each matrix, row l // 4, elements 2 (l % 4), + 1.
    Checks that the 8 rows of each matrix lie in 8 distinct bank groups."""
    flat = planes.reshape(-1)
    rows = []
    for lane in range(32):
        where, byte = _lane_address(warp, lane, kh, kw, din, plane)
        rows.append(flat[byte // 2: byte // 2 + 8] if where == "plane" else np.zeros(8))
        rows[-1] = (rows[-1], (byte // 16) % 8)
    regs = np.zeros((32, 4, 2))
    for j in range(4):
        assert len({rows[8 * j + i][1] for i in range(8)}) == 8
        for lane in range(32):
            regs[lane, j] = rows[8 * j + lane // 4][0][2 * (lane % 4): 2 * (lane % 4) + 2]
    return regs


def _a_matrix(regs):
    """The mma A operand [16, 16] that the lanes' fragments (a0..a3) form."""
    a = np.full((16, 16), np.nan)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a[g, 2 * t: 2 * t + 2] = regs[lane, 0]
        a[g + 8, 2 * t: 2 * t + 2] = regs[lane, 1]
        a[g, 8 + 2 * t: 10 + 2 * t] = regs[lane, 2]
        a[g + 8, 8 + 2 * t: 10 + 2 * t] = regs[lane, 3]
    return a


def _b_matrix(words, nh):
    """The mma B operand [16 k, 8 n] of n-half nh from the lanes' words."""
    b = np.full((16, 8), np.nan)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        b[2 * t: 2 * t + 2, g] = words[lane, 2 * nh]
        b[8 + 2 * t: 10 + 2 * t, g] = words[lane, 2 * nh + 1]
    return b


def _emulate_conv(planes, wsm, conv, bias, products, finite_hi):
    """Every warp of the team through conv3x3x3: out [512, 16] (f64 sums of
    the exact products)."""
    out = np.full((512, 16), np.nan)
    for warp in range(4):
        acc = np.zeros((8, 2, 16, 8)) + bias.reshape(1, 2, 1, 8)
        for khw in range(9):
            kh, kw = khw // 3, khw % 3
            for din in range(8):
                a = [_a_matrix(_ldmatrix_x4(planes, warp, kh, kw, din, p)) for p in range(3)]
                a.append(np.where(np.isfinite(a[0]), a[0], 0.0) if finite_hi else None)
                for kd in range(3):
                    dout = din + 1 - kd
                    if not 0 <= dout < 8:
                        continue
                    for at, wt in products:
                        words = wsm[conv, kd * 9 + khw, wt]
                        for nh in range(2):
                            acc[dout, nh] += a[at] @ _b_matrix(words, nh)
        # D fragment: lane (g, t) holds rows g, g + 8 at columns 2 t, 2 t + 1
        for d in range(8):
            for rr in range(2):
                for g in range(8):
                    out[_voxel(d, warp, rr, g)] = acc[d, :, g + 8 * rr].reshape(16)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_team_conv_matches_dense_conv(rng, dtype):
    bf16 = dtype == torch.bfloat16
    y = torch.relu(torch.from_numpy(rng.standard_normal((1, 16, 8, 8, 8)).astype(np.float32)))
    a_terms = [t.to(torch.float32) for t in split_bf16(y)]
    w = torch.from_numpy(0.05 * rng.standard_normal((2, 16, 16, 3, 3, 3)).astype(np.float32))
    w_terms = [w.to(torch.bfloat16).float()] if bf16 else [t.float() for t in split_bf16(w)]
    bias = rng.standard_normal((2, 16))
    # the kernel's inputs: planes [512 voxels, 16 ch] per term; weights
    # [conv, 27 taps, in, out] per term (the wrapper's layout)
    terms = np.stack([t[0].permute(1, 2, 3, 0).reshape(512, 16).numpy() for t in a_terms])
    planes = _store_planes(terms)
    wk = np.stack([t.permute(0, 3, 4, 5, 2, 1).reshape(2, 27, 16, 16).numpy() for t in w_terms])
    wsm = _stage_weights(wk)
    assert not np.isnan(wsm).any()
    products = rb.PRODUCTS_BF16 if bf16 else rb.PRODUCTS_F32
    for conv in range(2):
        got = _emulate_conv(planes, wsm, conv, bias[conv], products, not bf16)
        a64 = [t.double() for t in a_terms] + [a_terms[0].double()]
        want = torch.from_numpy(bias[conv]).reshape(1, 16, 1, 1, 1).clone()
        for at, wt in products:
            want = want + F.conv3d(a64[at], w_terms[wt][conv].double(), padding=1)
        want = want[0].permute(1, 2, 3, 0).reshape(512, 16).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)
        # and it is the f32-grade conv of the unsplit activation
        full = F.conv3d(y.double(), w[conv].double(), padding=1)[0].permute(1, 2, 3, 0)
        full = full.reshape(512, 16).numpy() + bias[conv]
        scale = F.conv3d(y.double(), w[conv].double().abs(), padding=1)[0]
        scale = scale.permute(1, 2, 3, 0).reshape(512, 16).numpy()
        if not bf16:
            assert (np.abs(got - full) <= 2.0 ** -22 * scale + 1e-30).all()


def test_every_lane_reads_a_zero_row_exactly_outside_the_leaf():
    """At each tap a lane's row is the shifted voxel when that lies inside
    the leaf, else one of the 8 zero units; never a unit of another voxel."""
    for warp in range(4):
        for kh in range(3):
            for kw in range(3):
                for lane in range(32):
                    row, hf = lane & 15, lane >> 4
                    h, w = 2 * warp + (row >> 3) + kh - 1, (row & 7) + kw - 1
                    where, byte = _lane_address(warp, lane, kh, kw, 5, 2)
                    if 0 <= h < 8 and 0 <= w < 8:
                        v = 5 * 64 + 8 * h + w
                        assert where == "plane" and byte == 2 * PLANE_BYTES + 16 * _unit(v, hf)
                    else:
                        assert where == "zero" and 0 <= byte < 128


def _finite_only(w):
    """The kernel's finite_only on uint32 bf16 pairs."""
    top = ((w & np.uint32(0x7F807F80)) + np.uint32(0x00800080)) & np.uint32(0x80008000)
    return w & ~((top >> np.uint32(15)) * np.uint32(0xFFFF))


def test_finite_only_zeroes_exactly_the_non_finite_halves(rng):
    halves = np.arange(1 << 16, dtype=np.uint32)
    other = rng.integers(0, 1 << 16, size=halves.size).astype(np.uint32)
    for w, lo_half in ((halves | (other << 16), True), ((halves << 16) | other, False)):
        got = _finite_only(w)
        mine = halves
        finite = (mine & 0x7F80) != 0x7F80
        keep = np.where(finite, mine, 0).astype(np.uint32)
        other_finite = (other & 0x7F80) != 0x7F80
        other_keep = np.where(other_finite, other, 0).astype(np.uint32)
        want = (keep | (other_keep << 16)) if lo_half else ((keep << 16) | other_keep)
        np.testing.assert_array_equal(got, want)
