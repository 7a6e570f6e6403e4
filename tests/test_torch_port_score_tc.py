"""The tensor-core score kernel's arithmetic and operand layout, on the CPU.

`csrc/score_argmin_tc.cu` multiplies bf16 terms on the tensor cores. What it
computes is repeated here without a card:

  * `split_bf16`: three bf16 terms rebuild an f32 value bit for bit; the
    small terms of a non-finite value are zero.
  * `score_argmin_split_plain` (the kernel's products, term by term, f32
    sums) against the Pallas kernels in interpret mode, as
    tests/test_torch_port_kernels.py runs them: indices equal except rows
    whose best and runner-up JAX scores differ by less than NEAR_TIE = 1e-5
    relative to the best (f32 sums taken in another order).
  * a numpy emulation of one warpgroup: each thread's A fragments read from
    the row tile, B read from the prepared operand at the byte offsets the
    MMA descriptor gives, the accumulator registers mapped back to
    (row, code), and the two-pass argmin of the epilogue with its hit sums.
  * `VQCodec` prepares the operands once; they equal those made on the fly.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.ops import quantize as jq
from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.models.quantizer import nearest_indices, rvq_indices
from vqvdb_tpu_torch.ops import quantize as q
from vqvdb_tpu_torch.runtime.codec import VQCodec

torch.set_num_threads(2)

MODELS = Path(__file__).parent.parent / "models"
NEAR_TIE = 1e-5  # relative best-vs-runner-up gap of the JAX scores


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the split
# ---------------------------------------------------------------------------

def test_split_bf16_rebuilds_f32_bit_for_bit(rng):
    # magnitudes 1e-30 .. 1e38: every term stays a normal bf16 number
    x = _rand(rng, 20000) * np.exp(rng.uniform(-69, 87, 20000)).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-30,
                                       1.0 + 2.0 ** -23, 255.99998])])
    x = x[np.isfinite(x)]
    hi, mid, lo = q.split_bf16(torch.from_numpy(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (lo.float() + mid.float()) + hi.float()
    np.testing.assert_array_equal(back.numpy().view(np.uint32) & 0x7FFFFFFF,
                                  x.view(np.uint32) & 0x7FFFFFFF)  # -0.0 may come back +0.0
    # the terms shrink by 2^-8 each
    nz = x != 0
    assert (mid.float().abs().numpy()[nz] <= np.abs(x[nz]) * 2.0 ** -8).all()
    assert (lo.float().abs().numpy()[nz] <= np.abs(x[nz]) * 2.0 ** -16).all()


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_split_bf16_term_count_and_error(rng, terms):
    x = torch.from_numpy(_rand(rng, 5000))
    parts = q.split_bf16(x, terms)
    assert len(parts) == terms
    err = (sum(p.float() for p in parts) - x).abs() / x.abs().clamp(min=1e-30)
    assert err.max() <= 2.0 ** (-8 * terms)


def test_split_bf16_non_finite_values():
    big = 3.4e38  # finite in f32, rounds up to inf in bf16
    x = torch.tensor([float("nan"), float("inf"), float("-inf"), big, -big, 1.5])
    hi, mid, lo = q.split_bf16(x)
    assert torch.isnan(hi[0]) and hi[1] == float("inf") and hi[2] == float("-inf")
    assert hi[3] == float("inf") and hi[4] == float("-inf")
    assert not mid[:5].any() and not lo[:5].any()
    assert not torch.isnan(mid).any() and not torch.isnan(lo).any()
    assert hi[5] == 1.5


# ---------------------------------------------------------------------------
# (b) the kernel's arithmetic against the Pallas kernels
# ---------------------------------------------------------------------------

def _assert_equal_off_near_ties(got, ref, scores):
    two = np.sort(scores, axis=1)[:, :2]
    ties = (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))
    bad = got != ref
    assert not (bad & ~ties).any(), f"{int((bad & ~ties).sum())} rows differ off near-ties"
    return int(bad.sum())


@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [8, 32, 64, 128])
@pytest.mark.parametrize("n", [1000, 1024])
def test_split_scores_match_pallas_score_argmin(rng, n, f, rows_dtype):
    k = 256
    h, m, c = _rand(rng, n, f), _rand(rng, f, k), _rand(rng, 1, k)
    ht = torch.from_numpy(h).to(getattr(torch, rows_dtype))
    jh = jnp.asarray(ht.float().numpy()).astype(rows_dtype)
    ref = np.asarray(jq.fused_score_argmin(jh, jnp.asarray(m), jnp.asarray(c),
                                           tile_n=256, interpret=True))
    got = q.score_argmin_split_plain(ht, torch.from_numpy(m), torch.from_numpy(c))
    assert got.dtype == torch.int32 and got.shape == (n,)
    scores = np.asarray(jnp.dot(jh.astype(jnp.float32), jnp.asarray(m)) + jnp.asarray(c))
    _assert_equal_off_near_ties(got.numpy(), ref, scores)


@pytest.mark.parametrize("d", [8, 32, 64, 128])
@pytest.mark.parametrize("n", [1000, 1024])
def test_split_scores_match_pallas_nearest(rng, n, d):
    k = 256
    z, cb = _rand(rng, n, d), _rand(rng, k, d)
    ref = np.asarray(jq.fused_nearest_indices(jnp.asarray(z), jnp.asarray(cb),
                                              tile_n=256, interpret=True))
    prep = q.prepare_codebook(torch.from_numpy(cb))
    got = q.score_argmin_split_plain(torch.from_numpy(z), prep.m, prep.c).numpy()
    scores = (cb * cb).sum(1)[None, :] - 2.0 * (z @ cb.T)
    _assert_equal_off_near_ties(got, ref, scores)


def test_split_scores_ties_nan_and_infinities(rng):
    """Duplicate codes tie exactly (integer-valued inputs); a NaN row gives
    the first code; an infinite value gives +-inf scores, not NaN, where a
    small term of M is zero."""
    f, k = 32, 64
    h = rng.integers(-3, 4, size=(200, f)).astype(np.float32)
    m = rng.integers(-3, 4, size=(f, k)).astype(np.float32)  # mid = lo = 0 everywhere
    m[6:8][m[6:8] == 0] = 1.0  # no inf * 0 in the plain version either
    c = rng.integers(-40, 40, size=(1, k)).astype(np.float32)
    m[:, 50] = m[:, 9]
    c[0, 9] = c[0, 50] = -10000.0
    h[3, 5] = np.nan
    h[4, 6] = np.inf
    h[5, 7] = -np.inf
    for dtype in (torch.float32, torch.bfloat16):
        ht, mt, ct = torch.from_numpy(h).to(dtype), torch.from_numpy(m), torch.from_numpy(c)
        got = q.score_argmin_split_plain(ht, mt, ct)
        want = q.score_argmin_plain(ht, mt, ct)
        assert torch.equal(got, want)
        assert got[0] == 9 and got[3] == 0
        assert m[6, got[4]] < 0 and m[7, got[5]] > 0  # a -inf score won


# ---------------------------------------------------------------------------
# (c) the prepared operand, the fragments and the epilogue, emulated
# ---------------------------------------------------------------------------

def _b_tile(operand_flat, k, d, term, u):
    """B [16, k] of chunk d, M term `term`, k16 step u, read the way the MMA
    descriptor walks shared memory (bf16 elements): 8 x 8 core matrices of 64
    contiguous elements, LBO 64 elements between the depth halves, SBO 128
    elements between groups of 8 codes; a code's 8 depths are contiguous."""
    base = ((d * 3 + term) * 2 + u) * 16 * k
    kk, n = np.meshgrid(np.arange(16), np.arange(k), indexing="ij")
    return operand_flat[base + (n // 8) * 128 + (kk // 8) * 64 + (n % 8) * 8 + kk % 8]


def _a_tile(rows, d, u):
    """A [64, 16] of chunk d, step u, from each thread's reads of the
    row-major tile: the thread of quad lane t, row g of warp w holds, of rows
    16 w + g and + 8, depths 32 d + 8 t + 4 u .. + 3: the first pair as MMA
    depths 2t, 2t + 1, the second as 2t + 8, 2t + 9."""
    a = np.zeros((64, 16), rows.dtype)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in (0, 8):
                row = 16 * w + g + r
                x = rows[row, 32 * d + 8 * t + 4 * u: 32 * d + 8 * t + 4 * u + 4]
                a[row, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = x
    return a


def _emulate_scores(row_terms, products, operand, k):
    """f32 scores [64, k] of one warpgroup tile: per chunk, the products in
    order the kernel starts them, each a sum of two k16 MMAs."""
    flat = operand.float().numpy().reshape(-1)
    acc = np.zeros((64, k), np.float32)
    for d in range(row_terms[0].shape[1] // 32):
        for ht, mt in products:
            for u in range(2):
                acc += _a_tile(row_terms[ht], d, u) @ _b_tile(flat, k, d, mt, u)
    return acc


def _emulate_epilogue(acc, c):
    """The argmin as the kernel's threads take it: register 4j + 2r + v of the
    thread (warp w, row g, quad lane t) is the score of row 16 w + g + 8 r,
    code 8 j + 2 t + v."""
    k = acc.shape[1]
    out = np.zeros(64, np.int64)
    for row in range(64):
        s = acc[row] + c
        low = np.float32(np.inf)
        for code in range(k):  # min.NaN over threads and quad: NaN if any NaN
            if not np.isnan(low) and (np.isnan(s[code]) or s[code] < low):
                low = s[code]
        best = []
        for t in range(4):
            codes = [8 * j + 2 * t + v for j in range(k // 8) for v in range(2)]
            total = np.float32(0)
            for code in codes:
                hit = np.float32(1.0) if s[code] == low else np.float32(0.0)
                total = np.float32(hit * np.float32(1024 + code - 2 * t) + total)
            total = int(total)
            mine = (total & 1023) + 2 * t if total >> 10 == 1 else np.iinfo(np.int32).max
            if total >> 10 > 1 or np.isnan(low):
                for code in reversed(codes):
                    if s[code] == low or np.isnan(s[code]):
                        mine = code
            best.append(mine)
        out[row] = min(best)
    return out


@pytest.mark.parametrize("f,k", [(64, 256), (8, 64), (96, 128), (32, 192)])
@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
def test_emulated_warpgroup_reproduces_scores_and_argmin(rng, f, k, rows_dtype):
    h = torch.from_numpy(_rand(rng, 64, f)).to(getattr(torch, rows_dtype))
    m, c = torch.from_numpy(_rand(rng, f, k)), torch.from_numpy(_rand(rng, k))
    prep = q.prepare_scores(m, c)
    fp = -(-f // 32) * 32
    assert prep.operand.shape == (1, fp // 32, 3, 2, k // 8, 2, 8, 8)
    assert prep.operand.dtype == torch.bfloat16 and prep.operand.is_contiguous()
    padded = torch.nn.functional.pad(h.float(), (0, fp - f))
    if rows_dtype == "bfloat16":
        terms, products = [padded, None, None], q.PRODUCTS_BF16_ROWS
    else:
        terms, products = [t.float() for t in q.split_bf16(padded)], q.PRODUCTS_F32_ROWS
    terms.append(torch.where(torch.isfinite(terms[0]), terms[0], torch.zeros(())))
    acc = _emulate_scores([None if t is None else t.numpy() for t in terms],
                          products, prep.operand, k)
    exact = h.double() @ m.double()
    scale = (h.double().abs() @ m.double().abs()).numpy()
    assert (np.abs(acc - exact.numpy()) <= 4e-7 * scale + 1e-30).all()
    got = _emulate_epilogue(acc, c.numpy())
    np.testing.assert_array_equal(got, np.argmin(acc + c.numpy()[None, :], axis=1))
    want = q.score_argmin_split_plain(h, m, c).numpy()
    two = np.sort((exact + c.double()).numpy(), axis=1)[:, :2]
    loose = (two[:, 1] - two[:, 0]) < 1e-5 * np.maximum(1.0, np.abs(two[:, 0]))
    assert ((got == want) | loose).all()


def test_emulated_epilogue_ties_and_nan(rng):
    k = 256
    acc = rng.integers(-50, 50, size=(64, k)).astype(np.float32)
    c = np.zeros(k, np.float32)
    acc[:, 200] = acc[:, 9] = -1000.0  # codes 9 and 200 lie in one thread
    acc[1, 77] = -1000.0               # and a third hit in another
    acc[2, [150, 31]] = np.nan
    acc[3, :] = np.inf
    got = _emulate_epilogue(acc, c)
    assert (got[[0, 1]] == 9).all() and got[2] == 31 and got[3] == 0
    assert (np.delete(got, [2, 3]) == 9).all()


# ---------------------------------------------------------------------------
# (d) the codec's cached operands
# ---------------------------------------------------------------------------

def _same_prepared(a, b):
    return (torch.equal(a.m, b.m) and torch.equal(a.c, b.c)
            and torch.equal(a.operand.view(torch.int16), b.operand.view(torch.int16)))


@pytest.mark.parametrize("name,fuse", [("scalar", True), ("scalar", False),
                                       ("scalar_reference", True), ("scalar_rvq2", True),
                                       ("vec3", True)])
def test_codec_prepares_score_operands_once(rng, name, fuse):
    tree, cfg = load_model(MODELS / f"{name}.vqmodel")
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=2, compute_dtype="float32",
                                           fuse_proj_quantize=fuse), device="cpu")
    if codec._score_mc is not None:
        fresh = q.prepare_scores(*codec._score_mc)
        assert _same_prepared(codec._score_prep, fresh) and codec._stage_prep is None
        f, k = codec._score_mc[0].shape
        assert fresh.operand.shape == (1, -(-f // 32), 3, 2, k // 8, 2, 8, 8)
    else:
        books = codec.params["vq"]["embedding"]
        books = books if books.dim() == 3 else books[None]
        assert codec._score_prep is None
        assert len(codec._stage_prep) == cfg.num_quantizers == books.shape[0]
        for prep, book in zip(codec._stage_prep, books):
            assert _same_prepared(prep, q.prepare_codebook(book))
            assert torch.equal(prep.codebook, book.float())
            assert torch.equal(prep.m, (-2.0 * book.float()).T)
    x = rng.random((2, 8, 8, 8, cfg.in_channels), dtype=np.float32)
    idx = codec.encode_leaves(x)
    assert idx.shape == (2,) + cfg.index_shape


def test_rvq_indices_with_prepared_stages(rng):
    s, k, d = 2, 64, 32
    books = torch.from_numpy(_rand(rng, s, k, d))
    z = torch.from_numpy(_rand(rng, 300, d))
    prepared = [q.prepare_codebook(b) for b in books]
    assert torch.equal(rvq_indices(z, books, prepared), rvq_indices(z, books))
    # a wrapper handed the prepared operand on the CPU runs the plain version
    assert torch.equal(q.fused_nearest_indices(z, prepared[0]).long(),
                       nearest_indices(z, books[0]))
    prep = q.prepare_scores(prepared[0].m, prepared[0].c)
    assert torch.equal(q.fused_score_argmin(z, prep),
                       q.score_argmin_plain(z, prep.m, prep.c))
    with pytest.raises(ValueError):  # M and c, or the prepared pair alone
        q.fused_score_argmin(z, prep, prep.c)
    with pytest.raises(ValueError):  # not made from a codebook
        q.fused_nearest_indices(z, prep)
    with pytest.raises(ValueError):  # K outside what the kernel takes
        q.prepare_scores(torch.zeros(32, q.MAX_CODES + 1), torch.zeros(q.MAX_CODES + 1))
