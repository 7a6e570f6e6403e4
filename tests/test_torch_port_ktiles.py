"""The score kernel's code tiles (any K from 1 to 65,536), emulated on the
CPU.

A launch of `csrc/score_argmin_tc.cu` scores one tile of kt <= 256 codes,
sets the scores of pad codes past K to +inf, takes its first minimum (a NaN
wins, the first NaN kept) and merges it into a running (best score, code)
per row: a strictly smaller score replaces the best, an equal one keeps the
earlier code, a NaN replaces any number and a held NaN stays. The emulation
below does exactly that on the scores of the kernel's arithmetic
(`ops.quantize.split_scores` over the prepared, padded M) and must equal
`score_argmin_split_plain` on the unpadded M: exactly for small integers
(every sum exact), and on real values too (the same f32 sums).
"""

import numpy as np
import pytest
import torch

from vqvdb_tpu_torch.ops import quantize as q


def _kernel_scores(h, prep):
    """f32 [N, tiles * kt] scores of the padded M, as the launches see them."""
    k = prep.m.shape[1]
    mp = torch.nn.functional.pad(prep.m, (0, prep.tiles * prep.tile - k))
    return (q.split_scores(h, mp) + prep.c_tiles[None, :]).numpy()


def _tile_argmin(s, valid, mask=True):
    """One launch's epilogue: (min score, first code at it) per row."""
    s = s.copy()
    if mask:
        s[:, valid:] = np.inf
    nan = np.isnan(s)
    low = np.where(nan.any(1), np.float32(np.nan), np.min(np.where(nan, np.inf, s), 1))
    hit = np.where(np.isnan(low)[:, None], nan, s == low[:, None])
    return low.astype(np.float32), hit.argmax(1)


def _emulate(h, prep, mask=True):
    scores = _kernel_scores(h, prep)
    k, kt = prep.m.shape[1], prep.tile
    best = code = None
    for t in range(prep.tiles):
        low, idx = _tile_argmin(scores[:, t * kt:(t + 1) * kt], min(kt, k - t * kt), mask)
        idx = idx + t * kt
        if best is None:
            best, code = low, idx
            continue
        take = (low < best) | (np.isnan(low) & ~np.isnan(best))
        best, code = np.where(take, low, best), np.where(take, idx, code)
    return code


@pytest.mark.parametrize("k,tile,tiles", [(1, 64, 1), (100, 128, 1), (256, 256, 1),
                                          (257, 192, 2), (320, 192, 2), (512, 256, 2),
                                          (4096, 256, 16), (65536, 256, 256)])
def test_code_tiles_and_operand_layout(rng, k, tile, tiles):
    """The fewest tiles of at most 256 codes, all of one width; each tile's
    operand is what one tile's worth of M prepares to."""
    assert q.code_tiles(k) == (tile, tiles)
    if k > 4096:
        return
    f = 40
    m = torch.from_numpy(rng.standard_normal((f, k)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(k).astype(np.float32))
    prep = q.prepare_scores(m, c)
    assert (prep.tile, prep.tiles) == (tile, tiles)
    assert prep.operand.shape == (tiles, 2, 3, 2, tile // 8, 2, 8, 8)
    assert prep.c_tiles.shape == (tiles * tile,) and torch.equal(prep.c_tiles[:k], c)
    assert not prep.c_tiles[k:].any()
    mp = torch.nn.functional.pad(m, (0, tiles * tile - k))
    for t in range(tiles):
        one = q.prepare_scores(mp[:, t * tile:(t + 1) * tile], torch.zeros(tile))
        assert torch.equal(prep.operand[t].view(torch.int16), one.operand[0].view(torch.int16))


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [320, 512, 1000])
def test_emulated_tiles_ties_and_nan_across_edges(rng, k, rows_dtype):
    n, f = 300, 32
    kt = q.code_tiles(k)[0]
    h = torch.from_numpy(rng.integers(-3, 4, size=(n, f)).astype(np.float32)).to(rows_dtype)
    m = torch.from_numpy(rng.integers(-3, 4, size=(f, k)).astype(np.float32))
    c = torch.from_numpy(rng.integers(-40, 40, size=k).astype(np.float32))
    last = k - 1
    edge = kt  # the first code of the second tile
    m[:, edge] = m[:, edge - 1]
    m[:, last] = m[:, 2]
    c[[2, last]] = -5000.0  # equal codes in the first and the last tile
    c[[edge - 1, edge]] = -4000.0
    cases = {"tie first vs last": c.clone()}
    c2 = c.clone()
    c2[[2, last]] = 0.0
    cases["tie across a tile edge"] = c2
    c3 = c.clone()
    c3[[last, k // 2]] = float("nan")
    cases["NaN in two tiles"] = c3
    want_codes = {"tie first vs last": 2, "tie across a tile edge": edge - 1,
                  "NaN in two tiles": min(last, k // 2)}
    for name, cc in cases.items():
        prep = q.prepare_scores(m, cc)
        got = _emulate(h, prep)
        want = q.score_argmin_split_plain(h, m, cc).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert (got == want_codes[name]).all(), name


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [100, 320, 4096])
def test_emulated_tiles_real_values_and_non_finite_rows(rng, k, rows_dtype):
    """Rows with NaN or infinities: a pad code is a zero column of M, so an
    infinite row value gives it inf * 0 = NaN, which would win unmasked."""
    n, f = 200, 64
    h = rng.standard_normal((n, f)).astype(np.float32)
    h[0::5, 3] = np.nan
    h[1::5, 7] = np.inf
    h[2::5, 9] = -np.inf
    h[3::5, 0], h[3::5, 1] = np.inf, -np.inf
    h = torch.from_numpy(h).to(rows_dtype)
    m = torch.from_numpy(rng.standard_normal((f, k)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(k).astype(np.float32))
    prep = q.prepare_scores(m, c)
    got = _emulate(h, prep)
    want = q.score_argmin_split_plain(h, m, c).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0::5] == 0).all() and (got < k).all()
    if k % prep.tile:
        unmasked = _emulate(h, prep, mask=False)
        assert (unmasked[1::5] >= k).all()  # a pad code would win the inf rows


def test_wrappers_take_large_codebooks_on_the_cpu(rng):
    """On CPU tensors the wrappers run their plain versions at any K."""
    k, d = 700, 16
    e = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((50, d)).astype(np.float32))
    prep = q.prepare_codebook(e)
    assert prep.tiles == 3 and prep.tile == 256
    ref = torch.argmin((e * e).sum(1)[None] - 2 * z @ e.T, 1)
    assert torch.equal(q.fused_nearest_indices(z, prep).long(), ref)
    assert torch.equal(q.fused_score_argmin(z, prep.m, prep.c).long(), ref)
    idx = q.fused_nearest_indices(z, e)
    assert torch.equal(q.fused_dequantize(idx, e), e[idx.long()])
