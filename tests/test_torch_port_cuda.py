"""The CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a card (the LZ4 shim's
needs none and runs anywhere). The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

For the quantizer kernels the inputs are small integers, so every product
and sum is exact in f32 (and in the score kernel's bf16 terms: an integer
up to 256 is its own hi term) and indices must be equal, ties going to the
first minimum; ragged row counts and out-of-range dequantize indices are
included. With real-valued inputs the score kernel is held to the argmin of
f64 scores except on rows whose two best differ by less than 1e-5 relative
(f32 sums in another order). The fused residual block is held to its plain version within
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
    """h, M, c of small integers with columns 9 and k - 3 identical and
    winning every row, so each row ties exactly between them."""
    h = rng.integers(-3, 4, size=(n, f)).astype(np.float32)
    m = rng.integers(-3, 4, size=(f, k)).astype(np.float32)
    c = rng.integers(-40, 40, size=(1, k)).astype(np.float32)
    m[:, k - 3] = m[:, 9]
    c[0, 9] = c[0, k - 3] = -10000.0
    return h, m, c


def _assert_argmin_off_near_ties(got, exact_scores):
    two = torch.topk(exact_scores, 2, dim=1, largest=False).values
    loose = (two[:, 1] - two[:, 0]) < 1e-5 * two[:, 0].abs().clamp(min=1.0)
    bad = got.long() != exact_scores.argmin(1)
    assert not (bad & ~loose).any(), f"{int((bad & ~loose).sum())} rows differ off near-ties"


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
@pytest.mark.parametrize("n", [1, 63, 1000, 262161])
@pytest.mark.parametrize("k", [64, 128, 192, 256])
@pytest.mark.parametrize("f", [8, 32, 64, 128])
def test_card_score_argmin_ties_and_ragged_rows(rng, f, k, n, dtype):
    dev = _card()
    h, m, c = (torch.from_numpy(a).to(dev)
               for a in _tied_scores_inputs(rng, n, f, k))
    h = h.to(dtype)  # small integers are exact in bf16
    launches = q.fused_score_argmin.launches
    got = q.fused_score_argmin(h, m, c)
    torch.cuda.synchronize()
    assert q.fused_score_argmin.launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, q.score_argmin_plain(h, m, c))
    assert (got == 9).all()
    c2 = c.clone()
    c2[0, [5, 40]] = float("nan")
    assert (q.fused_score_argmin(h, m, c2) == 5).all()
    # M prepared once gives the same indices as M split on the fly
    assert torch.equal(q.fused_score_argmin(h, q.prepare_scores(m, c)), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,k,n", [(8, 64, 1000), (32, 256, 262161), (64, 256, 262161),
                                   (64, 192, 5000), (128, 256, 262161), (128, 128, 63)])
def test_card_score_argmin_real_values(rng, f, k, n, dtype):
    dev = _card()
    h = torch.from_numpy(_rand(rng, n, f)).to(dev, dtype)
    m = torch.from_numpy(_rand(rng, f, k)).to(dev)
    c = torch.from_numpy(_rand(rng, 1, k)).to(dev)
    got = q.fused_score_argmin(h, m, c)
    _assert_argmin_off_near_ties(got, h.double() @ m.double() + c.double())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [32, 64, 128])
def test_card_score_argmin_non_finite_rows(rng, f, dtype):
    """A NaN gives NaN for every code, hence code 0; an infinity gives +-inf
    scores (NaN only where the plain version has one too: M zero there, or
    both infinities meeting in one score)."""
    dev = _card()
    n, k = 3000, 256
    h = _rand(rng, n, f)
    h[0::7, 3] = np.nan
    h[1::7, 5] = np.inf
    h[2::7, 1] = -np.inf
    h[3::7, 0] = np.inf
    h[3::7, 2] = -np.inf
    m = _rand(rng, f, k)
    m[5, 17] = 0.0  # inf * 0: NaN in both versions
    m[1, ::2] = np.round(m[1, ::2] * 4) / 4  # mid = lo = 0: must not turn inf into NaN
    h, m = torch.from_numpy(h).to(dev, dtype), torch.from_numpy(m).to(dev)
    c = torch.from_numpy(_rand(rng, 1, k)).to(dev)
    got = q.fused_score_argmin(h, m, c)
    want = q.score_argmin_plain(h, m, c)
    special = torch.arange(n, device=dev) % 7 < 4
    assert torch.equal(got[special], want[special])
    assert (got[0::7] == 0).all() and (got[1::7] == 17).all()
    _assert_argmin_off_near_ties(got[~special],
                                 h[~special].double() @ m.double() + c.double())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 1000, 262161])
@pytest.mark.parametrize("k", [64, 128, 192, 256])
@pytest.mark.parametrize("d", [8, 32, 64, 128])
def test_card_nearest(rng, d, k, n):
    dev = _card()
    cb = torch.from_numpy(rng.integers(-2, 3, size=(k, d)).astype(np.float32)).to(dev)
    cb[k - 1] = cb[3]
    z = torch.from_numpy(rng.integers(-2, 3, size=(n, d)).astype(np.float32)).to(dev)
    z[0] = cb[3]
    launches = q.fused_nearest_indices.launches
    got = q.fused_nearest_indices(z, cb)
    torch.cuda.synchronize()
    assert q.fused_nearest_indices.launches == launches + 1
    assert torch.equal(got.long(), nearest_indices(z, cb))
    assert got[0] <= 3 and torch.equal(cb[got[0]], cb[3])
    assert torch.equal(q.fused_nearest_indices(z, q.prepare_codebook(cb)), got)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n", [(128, 256, 262161), (32, 64, 777), (64, 192, 4096)])
def test_card_nearest_real_values(rng, d, k, n):
    dev = _card()
    cb = torch.from_numpy(_rand(rng, k, d)).to(dev)
    z = torch.from_numpy(_rand(rng, n, d)).to(dev)
    z[5, 7] = float("nan")
    got = q.fused_nearest_indices(z, cb)
    assert got[5] == 0
    e = cb.double()
    keep = torch.arange(n, device=dev) != 5
    _assert_argmin_off_near_ties(
        got[keep], (e * e).sum(1)[None, :] - 2.0 * (z[keep].double() @ e.T))


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
        q.fused_score_argmin(h, torch.zeros(64, 0, device=dev),
                             torch.zeros(1, 0, device=dev))
    with pytest.raises(ValueError):  # z must be f32 on the card
        q.fused_nearest_indices(torch.zeros(8, 128, device=dev, dtype=torch.bfloat16), cb)
    with pytest.raises(ValueError):  # f16 rows are not taken
        q.fused_score_argmin(h.half(), torch.zeros(64, 64, device=dev),
                             torch.zeros(1, 64, device=dev))
    with pytest.raises(ValueError):  # rows on the card, M on the CPU
        q.fused_score_argmin(h, torch.zeros(64, 64), torch.zeros(1, 64))
    with pytest.raises(ValueError):  # rows of another depth than M
        q.fused_score_argmin(torch.zeros(8, 32, device=dev), torch.zeros(64, 64, device=dev),
                             torch.zeros(1, 64, device=dev))
    with pytest.raises(ValueError):  # rows that are not 16-byte aligned
        q.fused_score_argmin(torch.zeros(8 * 64 + 1, device=dev)[1:].view(8, 64),
                             torch.zeros(64, 256, device=dev), torch.zeros(1, 256, device=dev))
    assert q.fused_score_argmin(h[:0], torch.zeros(64, 64, device=dev),
                                torch.zeros(1, 64, device=dev)).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [100, 320, 512, 4096])
@pytest.mark.parametrize("f", [32, 64])
def test_card_score_argmin_code_tiles(rng, f, k, dtype):
    """K beyond one tile of 256 codes (and K not a multiple of 64): equal
    codes in different tiles tie to the first; a NaN in c wins from any
    tile, the first NaN kept."""
    dev = _card()
    n = 5000
    h, m, c = (torch.from_numpy(a).to(dev) for a in _tied_scores_inputs(rng, n, f, k))
    h = h.to(dtype)
    prep = q.prepare_scores(m, c)
    assert prep.tiles * prep.tile >= k and prep.tile <= 256
    launches = q.fused_score_argmin.launches
    got = q.fused_score_argmin(h, prep)
    torch.cuda.synchronize()
    assert q.fused_score_argmin.launches == launches + prep.tiles
    assert torch.equal(got, q.score_argmin_plain(h, m, c))
    assert (got == 9).all()
    c2 = c.clone()
    c2[0, 9] = c2[0, k - 3] = 0.0
    m2 = m.clone()
    m2[:, k - 1] = m2[:, k - 2] = m2[:, 0]
    c2[0, [0, k - 2, k - 1]] = -20000.0  # the first code and the last two tie
    assert (q.fused_score_argmin(h, m2, c2) == 0).all()
    c2[0, 0] = 0.0  # the last two tie, in the last tile
    assert (q.fused_score_argmin(h, m2, c2) == k - 2).all()
    c2[0, [k - 1, 40]] = float("nan")
    assert (q.fused_score_argmin(h, m2, c2) == 40).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [320, 512, 4096])
def test_card_score_argmin_code_tiles_real_and_non_finite(rng, k, dtype):
    """Real values against the f64 argmin; rows with NaN / +-inf planted
    equal the plain version, so pad codes (zero columns of M: inf * 0 =
    NaN) never win."""
    dev = _card()
    n, f = 4099, 64
    h = _rand(rng, n, f)
    h[0::7, 3] = np.nan
    h[1::7, 5] = np.inf
    h[2::7, 1] = -np.inf
    h[3::7, 0] = np.inf
    h[3::7, 2] = -np.inf
    h = torch.from_numpy(h).to(dev, dtype)
    m = torch.from_numpy(_rand(rng, f, k)).to(dev)
    c = torch.from_numpy(_rand(rng, 1, k)).to(dev)
    m[:, k - 1], c[0, k - 1] = m[:, 5], c[0, 5]  # one code in the first tile and the last
    got = q.fused_score_argmin(h, m, c)
    want = q.score_argmin_plain(h, m, c)
    special = torch.arange(n, device=dev) % 7 < 4
    assert torch.equal(got[special], want[special])
    assert (got[0::7] == 0).all() and (got < k - 1).all() and (got == 5).any()
    _assert_argmin_off_near_ties(got[~special],
                                 h[~special].double() @ m.double() + c.double())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [320, 512, 4096])
def test_card_nearest_code_tiles(rng, k):
    dev = _card()
    d, n = 64, 3001
    cb = torch.from_numpy(rng.integers(-2, 3, size=(k, d)).astype(np.float32)).to(dev)
    cb[k - 1] = cb[3]
    cb[300] = cb[299]  # equal codes on either side of a tile edge (kt 192 or 256)
    z = torch.from_numpy(rng.integers(-2, 3, size=(n, d)).astype(np.float32)).to(dev)
    z[0] = cb[3]
    z[1] = cb[299]
    z[2, 4] = float("inf")
    got = q.fused_nearest_indices(z, cb)
    assert torch.equal(got.long(), nearest_indices(z, cb))
    assert got[0] == 3 and got[1] == 299
    e = torch.from_numpy(_rand(rng, k, d)).to(dev)
    zr = torch.from_numpy(_rand(rng, n, d)).to(dev)
    e64 = e.double()
    _assert_argmin_off_near_ties(q.fused_nearest_indices(zr, e),
                                 (e64 * e64).sum(1)[None, :] - 2.0 * (zr.double() @ e64.T))


@pytest.mark.cuda
def test_card_native_lz4_round_trip(rng):
    """The port's LZ4 shim, built from native/vqvdb_native.cpp on this host
    (no card needed), on compressible and random bytes."""
    from vqvdb_tpu_torch.runtime import native_io

    assert native_io.backend() == "native" and native_io.version() >= 2
    for raw in (np.repeat(rng.integers(0, 4, 5000, dtype=np.uint8), 7).tobytes(),
                rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(), b"x"):
        blob = native_io.lz4_compress(raw)
        assert native_io.lz4_decompress(blob, len(raw)) == raw
    with pytest.raises(ValueError):
        native_io.lz4_decompress(blob[:-1] + b"\xff\xff", 1)


def _rb_params(rng, dev, c=16):
    """A residual block's tree in the port's layout (OIDHW convs)."""
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    conv = lambda: {"w": t(0.05 * rng.standard_normal((c, c, 3, 3, 3))),
                    "b": t(0.1 * rng.standard_normal(c))}
    gn = lambda: {"scale": t(1 + 0.1 * rng.standard_normal(c)),
                  "bias": t(0.1 * rng.standard_normal(c))}
    return {"gn1": gn(), "conv1": conv(), "gn2": gn(), "conv2": conv()}


# (spatial, channels, groups) of every GroupNorm the committed models reach,
# packed_stem's 8^3 stage, and chip_smoke.py's derived model of width 160
GN_SHAPES = [((8, 8, 8), 64, 8), ((4, 4, 4), 128, 8), ((4, 4, 4), 64, 8), ((8, 8, 8), 16, 4),
             ((8, 8, 8), 8, 4), ((8, 8, 8), 16, 8), ((4, 4, 4), 32, 8), ((4, 4, 4), 160, 8)]


def _gn_inputs(rng, dev, n, spatial, c, dtype):
    """Conv-output-like leaves (a per-channel spread and offset) and
    trained-looking affine params."""
    x = (rng.standard_normal((n,) + spatial + (c,)) * rng.uniform(0.5, 2.0, c)
         + rng.uniform(-0.5, 0.5, c))
    params = {"scale": torch.from_numpy(1 + 0.2 * rng.standard_normal(c)).to(dev, torch.float32),
              "bias": torch.from_numpy(0.2 * rng.standard_normal(c)).to(dev, torch.float32)}
    return torch.from_numpy(x).to(dev, dtype), params


def _ulp(t):
    """One unit in the last place of t's dtype at max(|t|, 1): the outputs
    are normalised, so a value near 0 carries its group's statistics'
    rounding, a unit of the scale of 1."""
    mag = t.float().abs().clamp(min=1.0)
    return torch.exp2(torch.floor(torch.log2(mag)) - (7 if t.dtype == torch.bfloat16 else 23))


def _gn_f64(params, x, groups):
    b, c = x.shape[0], x.shape[-1]
    g = x.double().reshape(b, -1, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape)
    return (y * params["scale"].double() + params["bias"].double()).clamp(min=0)


def _assert_near_plain(got, want, params, x, groups):
    """bf16: within one unit in the last place of the plain version and
    equal on >= 99% of the values. f32: the two sums' other order moves the
    group's mean and variance by a few units of their own, which every value
    carries (up to 6 units and 83-89% equal on an H100), so f32 is held
    within 8 units of the plain version and, against an f64 GroupNorm, to
    no more than 1.5 times the plain version's largest error (1.13 times at
    most there)."""
    ok = want.isfinite()
    diff = (got.float() - want.float()).abs()[ok]
    if got.dtype == torch.bfloat16:
        assert (diff <= _ulp(want)[ok]).all()
        assert (got == want)[ok].float().mean().item() >= 0.99
        return
    assert (diff <= 8 * _ulp(want)[ok]).all()
    ref = _gn_f64(params, x, groups)
    scale = ref.abs().clamp(min=1.0)
    err = lambda y: ((y.double() - ref).abs() / scale)[ok].max().item()
    assert err(got) <= 1.5 * err(want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spatial,c,groups", GN_SHAPES)
def test_card_group_norm_relu(rng, spatial, c, groups, dtype):
    """The kernel against its plain version (the eager GroupNorm and ReLU;
    only the order of the two f32 sums differs, `_assert_near_plain`), one
    launch a call, the same bits on repeat."""
    from vqvdb_tpu_torch.ops.group_norm import group_norm_relu_fused, group_norm_relu_plain

    dev = _card()
    x, params = _gn_inputs(rng, dev, 333, spatial, c, dtype)
    launches = group_norm_relu_fused.launches
    got = group_norm_relu_fused(params, x, groups)
    torch.cuda.synchronize()
    assert group_norm_relu_fused.launches == launches + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_near_plain(got, group_norm_relu_plain(params, x, groups), params, x, groups)
    assert torch.equal(group_norm_relu_fused(params, x, groups), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_group_norm_relu_wide_leaves(rng, dtype):
    """chip_smoke.py's derived model of width 1,024: its 4^3 leaves, 128 KB
    in bf16 (through shared memory) and 256 KB in f32 (more than a block's
    shared memory: read from device memory in each pass), as near the plain
    version as the cells' shapes, at 1 and 301 leaves alike."""
    from vqvdb_tpu_torch.ops.group_norm import group_norm_relu_fused, group_norm_relu_plain

    dev = _card()
    x, params = _gn_inputs(rng, dev, 301, (4, 4, 4), 1024, dtype)
    got = group_norm_relu_fused(params, x, 8)
    _assert_near_plain(got, group_norm_relu_plain(params, x, 8), params, x, 8)
    assert torch.equal(group_norm_relu_fused(params, x[7:8], 8), got[7:8])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spatial,c,groups", GN_SHAPES[:4])
def test_card_group_norm_relu_leaf_bits_do_not_depend_on_the_batch(rng, spatial, c, groups,
                                                                   dtype):
    """A leaf gets the same bits alone and in batches of 2 to 4,097 leaves,
    at either end of the batch (other places in the kernel's blocks)."""
    from vqvdb_tpu_torch.ops.group_norm import group_norm_relu_fused

    dev = _card()
    x, params = _gn_inputs(rng, dev, 4097, spatial, c, dtype)
    whole = group_norm_relu_fused(params, x, groups)
    for n in (1, 2, 63, 64, 4096):
        assert torch.equal(group_norm_relu_fused(params, x[:n], groups), whole[:n]), n
        assert torch.equal(group_norm_relu_fused(params, x[-n:], groups), whole[-n:]), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_group_norm_relu_non_finite_leaves(rng, dtype):
    """NaN and +-inf planted in some leaves' groups give the plain version's
    pattern of NaN and inf, and leave the other values as near the plain
    version's as `_assert_near_plain` holds them."""
    from vqvdb_tpu_torch.ops.group_norm import group_norm_relu_fused, group_norm_relu_plain

    dev = _card()
    for spatial, c, groups in GN_SHAPES[:2]:
        x, params = _gn_inputs(rng, dev, 64, spatial, c, dtype)
        x[0, 0, 0, 0, 0] = float("nan")
        x[1, 1, 2, 3, c - 1] = float("inf")
        x[2, 0, 1, 0, 3] = float("-inf")
        x[3, 0, 0, 0, 0] = float("inf")
        x[3, 1, 0, 0, 1] = float("-inf")
        got = group_norm_relu_fused(params, x, groups)
        want = group_norm_relu_plain(params, x, groups)
        assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
        assert got.isnan().any()
        _assert_near_plain(got, want, params, x, groups)


@pytest.mark.cuda
def test_card_group_norm_dispatch_and_the_codecs_launches(rng, tmp_path):
    """`blocks.group_norm_relu` launches the kernel on the card only at
    inference and keeps the eager form (and autograd) in training; a codec
    call's stats count one launch per GroupNorm: 3 per flagship encode and
    decode batch, 7 per batch of upstream's vec3 encoder."""
    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.models import blocks
    from vqvdb_tpu_torch.ops.group_norm import group_norm_relu_fused
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    dev = _card()
    x, params = _gn_inputs(rng, dev, 8, (4, 4, 4), 64, torch.float32)
    launches = group_norm_relu_fused.launches
    leaf = x.clone().requires_grad_(True)
    got = blocks.group_norm_relu(params, leaf, 8)
    got.sum().backward()
    assert group_norm_relu_fused.launches == launches
    assert torch.equal(got.detach(), torch.relu(blocks.group_norm(params, x, 8)))
    with torch.inference_mode():
        blocks.group_norm_relu(params, x, 8)
    assert group_norm_relu_fused.launches == launches + 1
    n = 4096 + 300
    origins = (np.stack(np.unravel_index(np.arange(n), (32, 32, 32)), 1) * 8).astype(np.int32)
    for name, channels, per_batch in (("scalar", 1, (3, 3)), ("vec3_upstream", 3, (7, 5))):
        codec = api.make_codec(_MODELS / f"{name}.vqmodel", device="cuda")
        grid = LeafGrid("density", origins,
                        rng.random((n, 8, 8, 8, channels), np.float32) * 2 - 1)
        path = tmp_path / f"{name}.vqvdb"
        cstats = codec.compress(grid, path)
        _, dstats = codec.decompress(path)
        assert (cstats["group_norm_launches"], dstats["group_norm_launches"]) == (
            2 * per_batch[0], 2 * per_batch[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [8, 4])
@pytest.mark.parametrize("n", [4097, 301, 1])
def test_card_fused_rb(rng, dtype, groups, n):
    """4097 leaves: a ragged last pass of the persistent grid (one leaf more
    than the codec's batch); 301: fewer leaves than leaf slots on the card,
    so some blocks' teams run empty; 1: one team works."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_fused_rb_non_finite_leaves(rng, dtype):
    """A leaf with a NaN or an infinity in x is NaN throughout (its
    GroupNorm statistics are), as in the plain version; the other leaves
    agree within the tolerances above."""
    dev = _card()
    p = _rb_params(rng, dev)
    x = _rand(rng, 700, 8, 8, 8, 16)
    x[3, 1, 2, 3, 4] = np.nan
    x[100, 7, 7, 7, 15] = np.inf
    x[401, 0, 0, 0, 0] = -np.inf
    x[699, 4, 4, 4, 8] = np.inf
    x[699, 4, 4, 5, 8] = -np.inf
    x = torch.from_numpy(x).to(dev, dtype)
    got = residual_block_fused(p, x).float()
    want = residual_block_plain(p, x, 8, 0.1).float()
    planted = [3, 100, 401, 699]
    assert torch.isnan(got[planted]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 else dict(atol=1e-3, rtol=8e-3)
    torch.testing.assert_close(got, want, equal_nan=True, **tol)


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


# ---------------------------------------------------------------------------
# Rows of any depth (the streamed-depth mode) and rows of any byte width
# ---------------------------------------------------------------------------

DEEP_SHAPES = [(160, torch.float32), (512, torch.float32), (1024, torch.float32),
               (320, torch.bfloat16), (1024, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 4096])
@pytest.mark.parametrize("f,dtype", DEEP_SHAPES)
def test_card_score_argmin_deep_rows(rng, f, dtype, k):
    """Rows deeper than two full-depth stages fit take the streamed-depth
    mode: small integers (every sum exact) with two identical winning codes
    and ragged row counts equal the plain version; real values equal the
    f64 argmin off near-ties; NaN / +-inf rows equal the plain version."""
    dev = _card()
    plan = q.score_plan(f + (-f) % 32, q.code_tiles(k)[0], torch.finfo(dtype).bits // 8)
    assert plan.mode == "streamed"
    for n in (1, 127, 3001):
        h = torch.from_numpy(rng.integers(-3, 4, size=(n, f)).astype(np.float32))
        m = torch.from_numpy(rng.integers(-3, 4, size=(f, k)).astype(np.float32))
        c = torch.from_numpy(rng.integers(-40, 40, size=(1, k)).astype(np.float32))
        m[:, k - 3] = m[:, 9]
        c[0, 9] = c[0, k - 3] = -1e6
        h, m, c = h.to(dev, dtype), m.to(dev), c.to(dev)
        launches = q.fused_score_argmin.launches
        got = q.fused_score_argmin(h, m, c)
        torch.cuda.synchronize()
        assert q.fused_score_argmin.launches == launches + q.code_tiles(k)[1]
        assert (got == 9).all()
        c[0, 9] = c[0, k - 3] = 0.0
        assert torch.equal(q.fused_score_argmin(h, m, c), q.score_argmin_plain(h, m, c))
    n = 20011
    x = _rand(rng, n, f)
    x[0::7, 3] = np.nan
    x[1::7, f - 5] = np.inf
    x[2::7, 1] = -np.inf
    x[3::7, 0] = np.inf
    x[3::7, f - 2] = -np.inf
    h = torch.from_numpy(x).to(dev, dtype)
    m = torch.from_numpy(_rand(rng, f, k)).to(dev)
    c = torch.from_numpy(_rand(rng, 1, k)).to(dev)
    got = q.fused_score_argmin(h, m, c)
    special = torch.arange(n, device=dev) % 7 < 4
    assert torch.equal(got[special], q.score_argmin_plain(h, m, c)[special])
    assert (got[0::7] == 0).all()
    _assert_argmin_off_near_ties(got[~special],
                                 h[~special].double() @ m.double() + c.double())


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(160, 256), (512, 256), (1024, 256), (160, 4096)])
def test_card_nearest_deep_rows(rng, d, k):
    dev = _card()
    n = 5003
    cb = torch.from_numpy(rng.integers(-2, 3, size=(k, d)).astype(np.float32)).to(dev)
    cb[k - 1] = cb[3]
    z = torch.from_numpy(rng.integers(-2, 3, size=(n, d)).astype(np.float32)).to(dev)
    z[0] = cb[3]
    z[1, d - 1] = float("inf")
    z[2, 7] = float("nan")
    got = q.fused_nearest_indices(z, cb)
    assert torch.equal(got.long(), nearest_indices(z, cb))
    assert got[0] == 3 and got[2] == 0
    e = torch.from_numpy(_rand(rng, k, d)).to(dev)
    zr = torch.from_numpy(_rand(rng, n, d)).to(dev)
    e64 = e.double()
    _assert_argmin_off_near_ties(q.fused_nearest_indices(zr, e),
                                 (e64 * e64).sum(1)[None, :] - 2.0 * (zr.double() @ e64.T))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(20, torch.bfloat16), (21, torch.bfloat16),
                                     (5, torch.float32), (128, torch.bfloat16)])
@pytest.mark.parametrize("idx_dtype", [torch.uint8, torch.int32])
def test_card_dequantize_any_row_width(rng, d, dtype, idx_dtype):
    """Rows of 40, 42, 20 and 256 bytes (vectors of 8, 2, 4 and 16 bytes a
    thread): bit-equal to index_select, out-of-range indices give zero rows;
    a codebook view that starts off a 16-byte boundary too."""
    dev = _card()
    k, n = 256, 100003
    cb = torch.from_numpy(_rand(rng, k, d)).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, k, size=n).astype(np.int64))
    want = cb.index_select(0, idx.to(dev))
    if idx_dtype == torch.int32:
        idx[[0, n - 1]] = 300
        want[[0, n - 1]] = 0
    got = q.fused_dequantize(idx.to(dev, idx_dtype), cb)
    assert torch.equal(got, want)
    shifted = torch.empty(k * d + 1, dtype=dtype, device=dev)[1:].view(k, d)
    shifted.copy_(cb)
    assert torch.equal(q.fused_dequantize(idx.to(dev, idx_dtype), shifted), want)


# ---------------------------------------------------------------------------
# Training: the quantizer's kernel calls and a train step, card against CPU
# ---------------------------------------------------------------------------

def _near_tie_codes(z, emb):
    e = emb.double()
    d = (e * e).sum(1)[None, :] - 2.0 * (z.double() @ e.T)
    two = d.topk(2, dim=1, largest=False)
    tie = (two.values[:, 1] - two.values[:, 0]) < 1e-5 * two.values[:, 0].abs().clamp(min=1.0)
    return set(two.indices[tie].flatten().tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_train_quantizer(rng, stages, dtype):
    """vq_train_forward / rvq_train_forward on the card (one nearest-code and
    one dequantize launch a stage) against the same call on the CPU (their
    plain versions): codewords and the estimator's output equal where the
    codes agree, EMA state within 1e-5 relative off near-tie codes,
    commitment and perplexity within 1e-5 relative."""
    from vqvdb_tpu_torch.models import quantizer as mq

    dev = _card()
    k, d = 256, 128
    gen = torch.Generator().manual_seed(0)
    state = mq.init_vq_state(gen, k, d) if stages == 1 else mq.init_rvq_state(gen, stages, k, d)
    z = torch.from_numpy(_rand(rng, 64, 4, 4, 4, d) * 0.3).to(dtype)
    fwd = mq.vq_train_forward if stages == 1 else mq.rvq_train_forward
    before = (q.fused_nearest_indices.launches, q.fused_dequantize.launches)
    out = fwd(mq.VQState(*(t.to(dev) for t in state)), z.to(dev), 0.25, 0.95, 1e-4)
    torch.cuda.synchronize()
    assert (q.fused_nearest_indices.launches - before[0],
            q.fused_dequantize.launches - before[1]) == (stages, stages)
    ref = fwd(state, z, 0.25, 0.95, 1e-4)
    emb0 = state.embedding if stages == 1 else state.embedding[0]
    ties = _near_tie_codes(z.float().reshape(-1, d), emb0)
    keep = torch.ones(k, dtype=torch.bool)
    keep[list(ties)] = False
    for name in mq.VQState._fields:
        a, b = getattr(out[1], name).cpu(), getattr(ref[1], name)
        if name == "cluster_size":
            a, b = a[..., keep], b[..., keep]
        else:
            a, b = a[..., keep, :], b[..., keep, :]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(out[2:], ref[2:]):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    if not ties:
        torch.testing.assert_close(out[0].cpu(), ref[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["packed", "reference"])
def test_card_train_step_matches_cpu(rng, arch):
    """One f32 train step (TF32 off) of a full-width model from the same
    params on the card and on the CPU: metrics within 1e-5 relative, params
    within the Adam-step tolerance (at most 1% of a leaf's entries more than
    1e-2 lr apart, none more than 2 lr)."""
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.models.blocks import no_tf32
    from vqvdb_tpu_torch.train import train as T

    dev = _card()
    cfg = ModelConfig(encoder_arch=arch)
    tcfg = T.TrainConfig(compute_dtype="float32", batch_size=64)
    opt = T.make_optimizer(tcfg, 10)
    x = torch.from_numpy(rng.random((64, 8, 8, 8, 1), np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        state = T.make_train_state(cfg, tcfg, 10, d)
        with no_tf32(d):
            out[d.type] = T.train_step(state, x.to(d), opt, cfg, tcfg)
    (s_card, m_card, _), (s_cpu, m_cpu, _) = out["cuda"], out["cpu"]
    for key in m_cpu:
        assert float(m_card[key]) == pytest.approx(float(m_cpu[key]), rel=1e-5), key
    lr = tcfg.lr
    for a, b in zip(T.tree_leaves(T._trainable(s_card.params)),
                    T.tree_leaves(T._trainable(s_cpu.params))):
        diff = (a.cpu().double() - b.double()).abs()
        assert diff.max() <= 2 * lr and (diff > 1e-2 * lr).double().mean() <= 0.01
    assert s_card.params["encoder"]["proj"]["w"].device.type == "cuda"


_MODELS = __import__("pathlib").Path(__file__).resolve().parent.parent / "models"


@pytest.mark.cuda
def test_card_microbatcher_matches_the_codec(rng):
    """The flagship served on the card: 12 concurrent /encode_leaves
    requests, then /decode_indices of each answer, every answer equal to the
    codec's own encode_leaves / decode_indices of the same rows, the kernels
    launched once per device batch."""
    import http.client
    import io
    import threading

    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.serving import CodecService, make_server

    _card()
    codec = api.make_codec(_MODELS / "scalar.vqmodel", batch_size=1024, device="cuda")
    service = CodecService(codec)
    srv = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    chunks = [rng.random((int(n), 8, 8, 8, 1), np.float32) for n in rng.integers(50, 400, 12)]

    def post(path, arr):
        buf = io.BytesIO()
        np.save(buf, arr)
        conn = http.client.HTTPConnection(*srv.server_address, timeout=120)
        conn.request("POST", path, body=buf.getvalue())
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        assert resp.status == 200, data
        return np.load(io.BytesIO(data))

    try:
        for path, inputs in (("/encode_leaves", chunks), ("/decode_indices", None)):
            inputs = inputs if inputs is not None else answers
            before = (q.fused_score_argmin.launches, q.fused_dequantize.launches,
                      codec.profiler.report().get("device/dispatch", {}).get("count", 0))
            answers = [None] * len(inputs)
            threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
                i, post(path, inputs[i]))) for i in range(len(inputs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            batches = codec.profiler.report()["device/dispatch"]["count"] - before[2]
            score, deq = (q.fused_score_argmin.launches - before[0],
                          q.fused_dequantize.launches - before[1])
            assert (score, deq) == ((batches, 0) if path == "/encode_leaves" else (0, batches))
            for x, got in zip(inputs, answers):
                want = (codec.encode_leaves(x) if path == "/encode_leaves"
                        else codec.decode_indices(x))
                assert np.array_equal(got, want), path
        stats = service.stats()["microbatch"]
        assert stats["encode"]["steps"] + stats["encode"]["coalesced"] == len(chunks)
    finally:
        srv.shutdown()
        srv.server_close()
        service.close()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scalar", "scalar_reference", "scalar_rvq2"])
def test_card_encode_decode_indices_match_cpu(rng, name):
    """encode_to_indices / decode_from_indices of a shipped model on the card
    (f32, TF32 off) against their CPU run: indices equal except on near-tie
    rows of f64 scores (residual VQ: a row may first differ at a near-tie of
    that stage), leaves of the same indices within 1e-4."""
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.weights import params_from_jax
    from vqvdb_tpu_torch.models.blocks import no_tf32
    from vqvdb_tpu_torch.models.vqvae import decode_from_indices, encode_to_indices, encoder_apply

    dev = _card()
    tree, cfg = load_model(_MODELS / f"{name}.vqmodel")
    card, cpu = params_from_jax(tree, cfg, dev), params_from_jax(tree, cfg, "cpu")
    x = torch.from_numpy(rng.random((64, 8, 8, 8, 1), np.float32))
    before = (q.fused_nearest_indices.launches, q.fused_dequantize.launches)
    with torch.no_grad(), no_tf32(dev):
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = encode_to_indices(card, x.to(dev), cfg).cpu()
            rec = decode_from_indices(card, got.to(dev), cfg).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        want = encode_to_indices(cpu, x, cfg)
        ref = decode_from_indices(cpu, got, cfg)
        z = encoder_apply(cpu["encoder"], x, cfg).reshape(-1, cfg.embedding_dim)
    # encode: S nearest-code launches, S dequantize launches for the codewords
    # (and S more between residual-VQ stages); decode: S dequantize launches
    stages = cfg.num_quantizers
    deq = 2 * stages + (stages if stages > 1 else 0)
    assert (q.fused_nearest_indices.launches - before[0],
            q.fused_dequantize.launches - before[1]) == (stages, deq)
    books = cpu["vq"]["embedding"].reshape(stages, cfg.num_embeddings, -1).double()
    g, w = got.reshape(-1, stages).long(), want.reshape(-1, stages).long()
    res, same = z.double(), torch.ones(g.shape[0], dtype=torch.bool)
    for s in range(stages):
        e = books[s]
        d = (e * e).sum(1)[None, :] - 2.0 * res @ e.T
        two = d.topk(2, dim=1, largest=False).values
        tie = (two[:, 1] - two[:, 0]) < 1e-5 * two[:, 0].abs().clamp(min=1.0)
        assert not (same & (g[:, s] != w[:, s]) & ~tie).any(), f"stage {s}"
        same &= g[:, s] == w[:, s]
        res = res - e[w[:, s]]
    torch.testing.assert_close(rec, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scalar", "scalar_reference"])
def test_card_export_onnx_validates(tmp_path, capsys, name):
    """`export-onnx` with validation on the card: the ONNX graphs (numpy
    evaluator) against encode_to_indices / decode_from_indices on the card in
    f32 with TF32 off, by the JAX CLI's rule."""
    import json

    from vqvdb_tpu_torch.cli import main

    _card()
    before = (q.fused_nearest_indices.launches, q.fused_dequantize.launches)
    rc = main(["export-onnx", str(_MODELS / f"{name}.vqmodel"), str(tmp_path),
               "--device", "cuda"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["valid"] is True, out
    assert q.fused_nearest_indices.launches - before[0] == 1
    assert q.fused_dequantize.launches - before[1] == 2


@pytest.mark.cuda
def test_card_mesh_codec_equals_one_device(tmp_path, rng):
    """The flagship on a mesh of every visible card: the v3 and v6-int8
    files byte-identical to one card's, decompress bit-identical, and one
    score-argmin (dequantize) launch per shard step."""
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.parallel.mesh import make_mesh
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    dev = _card()
    tree, cfg = load_model(_MODELS / "scalar.vqmodel")
    mesh = make_mesh()
    bs = 64 * mesh.size
    single = VQCodec(tree, cfg, CodecConfig(batch_size=bs), device=dev)
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=bs), mesh=mesh)
    n = 3 * bs + 17
    origins = (np.stack(np.unravel_index(np.arange(n), (32, 32, 32)), 1) * 8).astype(np.int32)
    grid = LeafGrid("density", origins, rng.random((n, 8, 8, 8, 1), np.float32))
    shard_steps = sum(min(mesh.size, -(-(n - s) // 64)) for s in range(0, n, bs))
    for opts in ({}, dict(residual="int8")):
        single.compress(grid, tmp_path / "single.vqvdb", **opts)
        before = (q.fused_score_argmin.launches, q.fused_dequantize.launches)
        codec.compress(grid, tmp_path / "mesh.vqvdb", **opts)
        got = (q.fused_score_argmin.launches - before[0],
               q.fused_dequantize.launches - before[1])
        assert got == (shard_steps, shard_steps if opts else 0)
        assert (tmp_path / "mesh.vqvdb").read_bytes() == (tmp_path / "single.vqvdb").read_bytes()
        (a,), _ = single.decompress(tmp_path / "single.vqvdb")
        (b,), _ = codec.decompress(tmp_path / "single.vqvdb")
        assert np.array_equal(a.leaves, b.leaves)
    assert codec.check_latent_shape() == (4, 4, 4)


@pytest.mark.cuda
def test_card_nccl_group_of_one(tmp_path, rng):
    """An in-process NCCL group of one rank on a file store: three train
    steps with group= equal three without it bit for bit (an all-reduce over
    one rank, divided by 1, is exact), and the multi-process codec's file
    equals the single-device codec's."""
    import torch.distributed as dist

    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
    from vqvdb_tpu_torch.parallel.distributed import init_multi_host
    from vqvdb_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.train import train as T
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    dev = _card()
    info = init_multi_host(f"file://{tmp_path}/store", 1, 0, backend="nccl")
    try:
        assert info["process_count"] == 1 and dist.get_backend() == "nccl"
        mesh = make_mesh()
        assert mesh.multiprocess and mesh.devices == (torch.device("cuda", 0),)
        cfg = ModelConfig(embedding_dim=32, num_embeddings=64, encoder_arch="packed")
        tcfg = T.TrainConfig(batch_size=32, lr=1e-3)
        opt = T.make_optimizer(tcfg, 10)
        batches = [torch.from_numpy(rng.random((32, 8, 8, 8, 1), np.float32)).to(dev)
                   for _ in range(3)]
        states = []
        for step in (lambda s, b: T.train_step(s, b, opt, cfg, tcfg),
                     make_sharded_train_step(mesh, opt, cfg, tcfg)):
            state = T.make_train_state(cfg, tcfg, 10, dev)
            for b in batches:
                state, _, _ = step(state, b)
            states.append(T.tree_leaves(state.params))
        assert all(torch.equal(a, b) for a, b in zip(*states))
        tree, mcfg = load_model(_MODELS / "scalar.vqmodel")
        n = 300
        origins = (np.stack(np.unravel_index(np.arange(n), (8, 8, 8)), 1) * 8).astype(np.int32)
        grid = LeafGrid("density", origins, rng.random((n, 8, 8, 8, 1), np.float32))
        VQCodec(tree, mcfg, CodecConfig(batch_size=128), device=dev).compress(
            grid, tmp_path / "single.vqvdb")
        VQCodec(tree, mcfg, CodecConfig(batch_size=128), mesh=mesh).compress(
            grid, tmp_path / "group.vqvdb")
        assert (tmp_path / "group.vqvdb").read_bytes() == (tmp_path / "single.vqvdb").read_bytes()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scalar", "scalar_reference", "scalar_rvq2"])
@pytest.mark.parametrize("entries", [2, 4, 8, 16])
def test_card_one_card_mesh_of_many_entries(tmp_path, rng, name, entries):
    """A mesh of `entries` entries on one card (each its own stream; shards
    of 4096 / entries leaves, down to 256) writes one device's file at
    batch 4096, in bf16 and f32, and decodes it bit for bit."""
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.parallel.mesh import Mesh
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    dev = _card()
    tree, cfg = load_model(_MODELS / f"{name}.vqmodel")
    n = 4096 + 300
    origins = (np.stack(np.unravel_index(np.arange(n), (32, 32, 32)), 1) * 8).astype(np.int32)
    grid = LeafGrid("density", origins, rng.random((n, 8, 8, 8, 1), np.float32))
    mesh = Mesh((torch.device("cuda", dev.index or 0),) * entries, entries)
    for dtype in ("bfloat16", "float32"):
        ccfg = CodecConfig(compute_dtype=dtype)
        single = VQCodec(tree, cfg, ccfg, device=dev)
        codec = VQCodec(tree, cfg, ccfg, mesh=mesh)
        single.compress(grid, tmp_path / "single.vqvdb")
        codec.compress(grid, tmp_path / "mesh.vqvdb")
        assert (tmp_path / "mesh.vqvdb").read_bytes() == (tmp_path / "single.vqvdb").read_bytes()
        (a,), _ = single.decompress(tmp_path / "single.vqvdb")
        (b,), _ = codec.decompress(tmp_path / "single.vqvdb")
        assert np.array_equal(a.leaves, b.leaves)


@pytest.mark.cuda
def test_card_indices_beyond_256_codes_are_uint16(rng):
    """encode_to_indices returns uint16 beyond 256 codes on the card, as the
    JAX package does, and decode_from_indices takes them there: leaves
    within 1e-4 of the CPU's decode of the same indices (f32, TF32 off)."""
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.core.weights import params_from_jax, params_to_jax
    from vqvdb_tpu_torch.models.blocks import no_tf32
    from vqvdb_tpu_torch.models.vqvae import (
        decode_from_indices,
        encode_to_indices,
        init_vqvae_params,
    )

    dev = _card()
    cfg = ModelConfig(embedding_dim=16, num_embeddings=300)
    tree = params_to_jax(init_vqvae_params(torch.Generator().manual_seed(0), cfg))
    card, cpu = params_from_jax(tree, cfg, dev), params_from_jax(tree, cfg, "cpu")
    x = torch.from_numpy(rng.random((16, 8, 8, 8, 1), np.float32))
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), no_tf32(dev):
            idx = encode_to_indices(card, x.to(dev), cfg)
            rec = decode_from_indices(card, idx, cfg).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    assert idx.dtype == torch.uint16 and idx.device.type == "cuda"
    host = idx.cpu()
    assert host.numpy().dtype == np.uint16 and int(host.numpy().max()) < cfg.num_embeddings
    with torch.no_grad():
        ref = decode_from_indices(cpu, host, cfg)
    torch.testing.assert_close(rec, ref, rtol=0, atol=1e-4)


BENCH_ROWS = ("decode", "encode", "vec3_decode", "vec3_encode", "rvq2_decode",
              "rvq2_encode", "dense_decode_device", "dense_encode_device",
              "baseline_1", "baseline_2", "baseline_3")


@pytest.fixture(scope="module")
def bench_on_card():
    """`vqvdb_tpu_torch.bench.run` on the card at few steps, a 16^3-block
    volume (2 dense steps of 2,048) and, with data_parallel, a 10,000-leaf
    file: (its line, {row: record})."""
    from vqvdb_tpu_torch import bench

    _card()
    checks = []
    line = bench.run("cuda", checks=checks, data_parallel=True, decode_steps=8,
                     encode_steps=8, baseline_steps=8, vec3_steps=(8, 8), rvq2_steps=(8, 8),
                     dense_blocks=(16, 16, 16), dense_steps=4, dp_leaves=10_000)
    return line, {rec["row"]: rec for rec in checks}


@pytest.mark.cuda
@pytest.mark.parametrize("row", BENCH_ROWS)
def test_card_bench_row_replays_its_eager_step(bench_on_card, row):
    """Each bench row's captured step, replayed, gives its eager step's output
    bit for bit, and its capture recorded the row's kernel launches."""
    line, rows = bench_on_card
    rec = rows[row]
    assert rec["bit_equal"], rec
    kernels = {"encode": "score_argmin", "vec3_encode": "score_argmin",
               "rvq2_encode": "nearest_indices", "dense_encode_device": "score_argmin"}
    assert rec["launches"][kernels.get(row, "dequantize")] >= 1, rec
    assert rec["ms_per_step"] > 0
    assert line["device"] == torch.cuda.get_device_name()


@pytest.mark.cuda
def test_card_fenced_rate_raises_on_a_host_sync():
    """A step that reads a value back to the host cannot be captured:
    fenced_rate raises and does not time the eager loop instead."""
    from vqvdb_tpu_torch import bench

    dev = _card()

    def syncing(x):
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError):
        bench.fenced_rate(syncing, torch.ones(64, device=dev), 4, lambda x: x,
                          bench.consume_sum)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_bench_data_parallel_keys(bench_on_card):
    """run(data_parallel=True) adds bench.py's eight keys over every visible
    card, each rate and time finite and > 0."""
    from vqvdb_tpu_torch import bench

    line, _ = bench_on_card
    assert line["mesh_devices"] == torch.cuda.device_count()
    for key in bench.DP_KEYS[1:]:
        assert np.isfinite(line[key]) and line[key] > 0, (key, line[key])


@pytest.mark.cuda
def test_card_bench_dp_one_card_mesh_of_two():
    """bench_dp.bench_mesh_size on a one-card mesh of 2 entries (the shard
    shapes of two cards): its per-shard gather bit-equal to the full gather
    (host_stage_times raises otherwise), its file and decoded leaves those
    of no mesh, one score-argmin and one fused-block launch per encode shard
    step and one dequantize launch per decode shard step."""
    from vqvdb_tpu_torch import bench_dp
    from vqvdb_tpu_torch.parallel.mesh import Mesh

    dev = _card()
    bs, n = 512, 3000
    recs = [{}, {}]
    rows = [bench_dp.bench_mesh_size(0, bs, n, "bfloat16", dev, record=recs[0]),
            bench_dp.bench_mesh_size(2, bs, n, "bfloat16",
                                     mesh=Mesh((torch.device("cuda", dev.index or 0),) * 2, 2),
                                     record=recs[1])]
    assert recs[1]["file"] == recs[0]["file"]
    assert recs[1]["leaves"].tobytes() == recs[0]["leaves"].tobytes()
    assert np.isfinite(recs[0]["leaves"]).all()
    for size, row, rec in zip((1, 2), rows, recs):
        per = bs // size
        steps = sum(min(size, -(-min(bs, n - s) // per)) for s in range(0, n, bs))
        assert rec["compress_launches"]["score_argmin"] == steps
        assert rec["compress_launches"]["fused_rb"] == steps
        assert rec["decode_launches"]["dequantize"] == steps
        assert row["leaves"] == n and row["n_devices"] == size
        for key, v in row.items():
            if key.endswith(("_per_sec", "_per_batch")):
                assert np.isfinite(v) and v > 0, (key, v)
    assert "host_gather_shards_ms_per_batch" in rows[1]


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [0, 1])
def test_card_sop_cooks_through_the_launcher(tmp_path, residual):
    """The launcher pip generates for `vqvdb-torch`, on the HDK SOPs'
    encode and decode lines (no `--device`: the card is the default) run
    as popen runs them, on a blosc half-float bridge of 3,000 seeded leaves
    in a directory whose name holds a space and a `'`: each cook exits 0
    and writes the bytes the same argv writes through in-process main on
    the card (the decoded `.vdb` but for its header's UUID), which launches
    score-argmin once per encode batch and dequantize once per decode batch
    (and once per encode batch with a residual)."""
    import os
    import shlex
    from pathlib import Path

    from vqvdb_tpu_torch.cli import main as cli
    from vqvdb_tpu_torch.integrations import hdk
    from vqvdb_tpu_torch.tools.roundtrip import field
    from vqvdb_tpu_torch.vdb.openvdb_io import COMPRESS_BLOSC, write_vdb_leafgrids

    _card()
    repo = _MODELS.parent
    root = tmp_path / "SOP cooks 'hip'"
    root.mkdir()
    bridge = root / "bridge in.vdb"
    grid = field(3, 3000)
    write_vdb_leafgrids(bridge, [grid], compression=COMPRESS_BLOSC, half=True)
    cmd = hdk.write_launcher("vqvdb-torch", root / "bin")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(repo), os.environ.get("PYTHONPATH")])))
    model, bs = _MODELS / "scalar.vqmodel", 1024
    steps = -(-grid.num_leaves // bs)
    lines = [hdk.encode_line(cmd, bridge, root / "out.vqvdb", bs, model=model,
                             residual=residual),
             hdk.decode_line(cmd, root / "out.vqvdb", root / "out.vdb", bs, model=model)]
    wants = [{"score_argmin": steps, "dequantize": steps if residual else 0},
             {"score_argmin": 0, "dequantize": steps}]
    for line, want in zip(lines, wants):
        status, output = hdk.run_line(line, env=env, timeout=900)
        assert status == 0, output
        argv = shlex.split(line)
        assert argv[0] == str(cmd)
        out = Path(argv[3])
        twin = out.with_name("twin" + out.suffix)
        argv[3] = str(twin)
        before = {k: getattr(q, f"fused_{k}").launches for k in want}
        assert cli(argv[1:]) == 0
        torch.cuda.synchronize()
        assert {k: getattr(q, f"fused_{k}").launches - before[k] for k in want} == want
        if out.suffix == ".vdb":
            assert hdk.bridge_bytes(twin) == hdk.bridge_bytes(out)
        else:
            assert twin.read_bytes() == out.read_bytes()


@pytest.mark.cuda
def test_card_sop_cook_on_an_unwritable_build_cache_shows_the_oserror(tmp_path):
    """A cook whose build cache cannot be made (VQVDB_COMPILE_CACHE under a
    regular file, as a read-only install left at its default would be)
    exits 1 with the OSError's message in the combined output, which the
    SOP puts on the node; nothing falls back."""
    import os

    from vqvdb_tpu_torch.integrations import hdk
    from vqvdb_tpu_torch.tools.roundtrip import field
    from vqvdb_tpu_torch.vdb.openvdb_io import write_vdb_leafgrids

    _card()
    blocker = tmp_path / "a file"
    blocker.write_text("")
    bridge = tmp_path / "bridge.vdb"
    write_vdb_leafgrids(bridge, [field(3, 64)])
    cmd = hdk.write_launcher("vqvdb-torch", tmp_path / "bin")
    env = dict(os.environ, VQVDB_COMPILE_CACHE=str(blocker / "cache"),
               PYTHONPATH=os.pathsep.join(filter(None, [str(_MODELS.parent),
                                                        os.environ.get("PYTHONPATH")])))
    status, output = hdk.run_line(hdk.encode_line(cmd, bridge, tmp_path / "o.vqvdb",
                                                  model=_MODELS / "scalar.vqmodel"),
                                  env=env, timeout=300)
    assert status == 1, output
    assert "error: [Errno 20] Not a directory" in output and "Traceback" not in output


@pytest.mark.cuda
def test_card_stages_keep_a_rows_bits_down_to_one_leaf():
    """`tools/batch_invariance.py` on the card at 256 leaves in blocks of
    64 down to 1 leaf, odd sizes and their remainders included: every stage
    of the flagship, the reference arch and scalar_rvq2 (GroupNorm and the
    attention mean padded to MIN_REDUCE_ROWS rows, `models/blocks.py`) gives
    a row the same bits as the whole batch, in bf16 and f32."""
    from vqvdb_tpu_torch.tools import batch_invariance

    _card()
    out = batch_invariance.stages("cuda", n=256, sizes=(64, 16, 7, 4, 3, 2, 1))
    moved = [f"{m}/{dtype}/{stage}/{n}" for m, by_dtype in out["stages"].items()
             for dtype, by_stage in by_dtype.items() for stage, by_n in by_stage.items()
             for n, equal in by_n.items() if not equal]
    assert not moved, moved


@pytest.mark.cuda
@pytest.mark.parametrize("model,direction", [("scalar", "compress"), ("scalar", "decompress"),
                                             ("vec3", "decompress")])
def test_card_every_event_of_a_call_is_near_its_program_range(tmp_path, model, direction):
    """The card's twin of `test_torch_port_spans.py`'s nesting guard: the
    cells' codec (batch 4,096, bf16) traced with the card's activity, which
    adds a runtime event per launch; every torch op and runtime call of a
    compress or decompress of 9,000 leaves lies within LOOKBACK events of the
    opening of the innermost program range holding it, so the benchmark's
    trace reader finds that range."""
    from portbench.tracing import LOOKBACK
    from test_torch_port_spans import frame, traced_call

    from vqvdb_tpu_torch import api

    _card()
    codec = api.make_codec(_MODELS / f"{model}.vqmodel", device="cuda")
    acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    names, worst = traced_call(codec, direction, frame(9000, codec.mcfg.in_channels),
                               tmp_path / "f.vqvdb", acts)
    assert "device/dispatch" in names and "rb/conv2" in names
    assert max(worst.values()) < LOOKBACK, worst


@pytest.mark.cuda
def test_card_decompress_reads_back_into_pinned_caller_memory(tmp_path):
    """The cells' codec (flagship, batch 4,096, bf16) on a file of four
    grids, one of three batches: each grid's leaves are page-locked memory
    of torch's pool, bit-equal to `decode_indices` of the file's indices;
    with the first call's grids dropped, a second call reuses the pool's
    blocks (it adds none); two calls' grids held at once do not alias."""
    import gc

    from test_torch_port_readback import assert_grids_equal, expected, field

    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    _card()
    codec = api.make_codec(_MODELS / "scalar.vqmodel", device="cuda")
    rng = np.random.default_rng(0)
    n = 2 * 4096 + 808
    origins = (np.stack(np.unravel_index(np.arange(n), (32, 32, 32)), 1) * 8).astype(np.int32)
    big = LeafGrid("smoke", origins, rng.random((n, 8, 8, 8, 1), np.float32))
    path = tmp_path / "f.vqvdb"
    codec.compress([big, *field()], path)
    got, stats = codec.decompress(path)
    assert all(torch.from_numpy(g.leaves).is_pinned() for g in got)
    assert_grids_equal(got, expected(codec, path))
    assert stats["direct_readback_share"] == 1.0
    del got
    gc.collect()
    again, stats = codec.decompress(path)
    assert stats["pinned_pool_growth"] == 0, stats
    assert stats["direct_readback_share"] == 1.0
    third, _ = codec.decompress(path)
    for a, b in zip(again, third):
        assert not np.shares_memory(a.leaves, b.leaves)
        assert a.leaves.tobytes() == b.leaves.tobytes()


@pytest.mark.cuda
def test_card_encode_fine_is_timed_on_the_card_only_under_a_profiler(tmp_path):
    """upstream's vec3 model at its widths (`models/vec3_upstream.vqmodel`,
    the codec's defaults): a compress of 9,000 leaves (three batches) under
    `torch.profiler` counts `device/encode_fine` once a batch, and the
    trace holds the score kernel's 16 code tiles a batch; the same compress
    untraced counts no such stage. The file holds u16 indices equal to
    `encode_leaves`'."""
    from test_torch_port_spans import frame

    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader

    _card()
    codec = api.make_codec(_MODELS / "vec3_upstream.vqmodel", device="cuda")
    grid, path = frame(9000, 3), tmp_path / "f.vqvdb"
    codec.compress(grid, path, format_version=4)
    torch.cuda.synchronize()
    assert "device/encode_fine" not in codec.profiler.report()
    codec.profiler.reset()
    acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    launches = q.fused_score_argmin.launches
    with torch.profiler.profile(activities=list(acts)) as prof:
        codec.compress(grid, path, format_version=4)
    got = codec.profiler.report()
    fine = got["device/encode_fine"]
    assert fine["count"] == 3 == got["device/dispatch"]["count"], got
    assert 0.0 < fine["mean_ms"] < 1e3 * 10, fine
    tiles = [e for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and "score_argmin_kernel" in e.name()]
    assert len(tiles) == 3 * 16 == q.fused_score_argmin.launches - launches
    with VqvdbReader(path) as r:
        _, idx, _ = r.read_grid()
    assert r.version == 4 and idx.dtype == np.uint16 and idx.max() > 255
    assert np.array_equal(idx, codec.encode_leaves(grid.leaves))


# -- the decoder's head (csrc/decoder_head.cu) ---------------------------------

# (C_in, C_out): the flagship's and vec3's decoders, and each width with the
# other head.
HEAD_SHAPES = [(64, 1), (128, 3), (128, 1), (64, 3)]
HEAD_DTYPES = [torch.bfloat16, torch.float32]
# The kernel against its plain version: every value within ATOL, and 99%
# within 1e-5 (the sums' order; in bf16 a gate whose f32 value sits at a
# bf16 rounding boundary may round the other way and move its leaf by more).
HEAD_ATOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}


def _head_inputs(rng, dev, n, c, c_out, dtype=torch.bfloat16):
    """A trunk-like input (B, 4, 4, 4, C_in) of `dtype` and a head as
    `prepare_head` lays it out, with both operators: the fold 'k' (which the
    f32 kernel and the plain version read) and its tiles 'op' (the bf16
    kernel's)."""
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.ops import decoder_head as dh

    depth, n_out, hid = 64 * c, 512 * c_out, c // 4

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    k = normal(depth, n_out, scale=depth ** -0.5)
    head = {"k": k, "b": normal(n_out, scale=0.1), "op": dh.operator_tiles(k),
            "w1": normal(c, hid, scale=c ** -0.5), "w2": normal(hid, c, scale=hid ** -0.5)}
    x = (rng.standard_normal((n, 4, 4, 4, c)) * rng.uniform(0.5, 2.0, c)).astype(np.float32)
    return ({name: t.to(dev) for name, t in head.items()}, ModelConfig(in_channels=c_out),
            torch.from_numpy(x).to(dev, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("n", [4097, 300, 1])
@pytest.mark.parametrize("c,c_out", HEAD_SHAPES)
def test_card_decoder_head(rng, c, c_out, n, dtype):
    """The kernel against its plain version (the eager attention and the
    tail product, f32 operands for f32 features): every value
    within `HEAD_ATOL`, and 99% within 1e-5; two launches a call; the same
    bits on repeat."""
    from vqvdb_tpu_torch.ops import decoder_head as dh

    dev = _card()
    head, cfg, x = _head_inputs(rng, dev, n, c, c_out, dtype)
    launches = dh.decoder_head_fused.launches
    with torch.inference_mode():
        got = dh.decoder_head_fused(head, x, cfg)
        torch.cuda.synchronize()
        assert dh.decoder_head_fused.launches == launches + 2
        assert got.shape == (n, 8, 8, 8, c_out) and got.dtype == torch.float32
        want = dh.decoder_head_plain(head, x, cfg)
        assert got.isfinite().all()
        torch.testing.assert_close(got, want, atol=HEAD_ATOL[dtype], rtol=0)
        assert ((got - want).abs() <= 1e-5).float().mean().item() >= 0.99
        assert torch.equal(dh.decoder_head_fused(head, x, cfg), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("c,c_out", HEAD_SHAPES[:2])
def test_card_decoder_head_leaf_bits_do_not_depend_on_the_batch(rng, c, c_out, dtype):
    """A leaf gets the same bits alone, among 4,097 leaves, in a batch of
    4,096 and at another place in its tile (the batch shifted by 1 and 77)."""
    from vqvdb_tpu_torch.ops import decoder_head as dh

    dev = _card()
    head, cfg, x = _head_inputs(rng, dev, 4097, c, c_out, dtype)
    with torch.inference_mode():
        whole = dh.decoder_head_fused(head, x, cfg)
        for sl in (slice(0, 1), slice(4096, 4097), slice(0, 4096), slice(1, None),
                   slice(77, 3000), slice(5, 6)):
            assert torch.equal(dh.decoder_head_fused(head, x[sl], cfg), whole[sl]), sl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
def test_card_decoder_head_in_a_cuda_graph(rng, dtype):
    """Captured in a CUDA graph and replayed, the head gives the eager
    call's bits (no synchronisation or allocation inside the launches)."""
    from vqvdb_tpu_torch.ops import decoder_head as dh

    dev = _card()
    head, cfg, x = _head_inputs(rng, dev, 1000, 128, 3, dtype)
    with torch.inference_mode():
        eager = dh.decoder_head_fused(head, x, cfg)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            dh.decoder_head_fused(head, x, cfg)  # warm-up off the default stream
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = dh.decoder_head_fused(head, x, cfg)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f16", "width48", "width160", "width32", "no_tiles",
                                  "no_fold"])
def test_card_decoder_head_refuses_what_it_cannot_take(rng, case):
    """An f16 input, a width the kernel has no instantiation for, or a head
    without the operator its step reads (a bf16 step without tiles, an f32
    step without the f32 fold) raises ValueError on the card before any
    launch; nothing falls back."""
    from vqvdb_tpu_torch.ops import decoder_head as dh

    dev = _card()
    c = {"width48": 48, "width160": 160, "width32": 32}.get(case, 64)
    head, cfg, x = _head_inputs(rng, dev, 8, c, 1, torch.float32 if case == "no_fold"
                                else torch.bfloat16)
    if case == "f16":
        x = x.half()
    elif case in ("no_tiles", "no_fold"):
        del head["op" if case == "no_tiles" else "k"]
    launches = dh.decoder_head_fused.launches
    with pytest.raises(ValueError):
        dh.decoder_head_fused(head, x, cfg)
    assert dh.decoder_head_fused.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["scalar", "vec3"])
def test_card_decode_step_launches_the_head_and_no_mm(name, dtype):
    """A traced decode step of the cells' codec (batch 4,096), in bf16 and
    in f32, runs the head as its two kernels (the gate, the product) and no
    `aten::mm`; the step equals the plain graph's within the head's
    tolerance. The codec holds only the operator its step reads."""
    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.models import vqvae
    from vqvdb_tpu_torch.ops import decoder_head as dh

    _card()
    codec = api.make_codec(_MODELS / f"{name}.vqmodel", device="cuda", compute_dtype=dtype)
    assert ("op" in codec._head) == (dtype == "bfloat16") != ("k" in codec._head)
    cfg = codec.mcfg
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.num_embeddings, (4096,) + cfg.index_shape).astype(np.int32)).cuda()
    # the plain version's head, folded as the codec's constructor folds it:
    # outside inference mode
    plain = dh.prepare_head(codec.params["decoder"], cfg, torch.float32)
    with torch.inference_mode():
        codec._decode_step(idx)
        torch.cuda.synchronize()
        launches = dh.decoder_head_fused.launches
        acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=list(acts)) as prof:
            got = codec._decode_step(idx)
            torch.cuda.synchronize()
        assert dh.decoder_head_fused.launches == launches + 2
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        kernels = [n for n in names if "gate_kernel" in n or "head_kernel" in n]
        assert len(kernels) == 2, kernels
        assert "aten::mm" not in names and "aten::matmul" not in names
        z = codec._codebook[idx.reshape(-1).long()].reshape(
            (4096,) + cfg.latent_shape + (cfg.embedding_dim,))
        want = dh.decoder_head_plain(plain, vqvae.decoder_trunk(
            codec.params["decoder"], z, cfg), cfg)
        torch.testing.assert_close(got, want, atol=HEAD_ATOL[codec.dtype], rtol=0)
