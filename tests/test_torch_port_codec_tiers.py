"""The port's codec on the v4/v5/v6 tiers against the JAX package's, on the
CPU in f32: the residual tiers, codebooks beyond 256 codes, streaming,
grid and bounding-box selection, transcode and verify.

Tolerances, as in test_torch_port_codec.py: indices equal except on rows
whose best and runner-up JAX scores differ by less than NEAR_TIE relative
(for residual-VQ at the first stage where the row differs); decoded leaves
within ATOL on the same indices. A v6 file's residual stream is the error
against the writer's own decode, which differs between the packages by
rounding (~1e-6 here), so v6 files are compared through their indices and
their decoded leaves, and the int8 tier's bound (max error <= max scale / 2)
is held on each package's own file. The JAX side runs its XLA paths and the
Pallas residual block in interpret mode, as its own tests run them, and its
native LZ4 encoder (`jax_native_lz4`), whose bytes the port's v5-lz4 files
must equal.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.artifact import load_model as jax_load_model
from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.format import transcode as jtranscode
from vqvdb_tpu.format import verify as jverify
from vqvdb_tpu.models import quantizer as jquantizer
from vqvdb_tpu.models import vqvae as jvqvae
from vqvdb_tpu.models.vqvae import init_vqvae_params
from vqvdb_tpu.runtime import native_io as jnative
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.vdb.grid import LeafGrid as JaxLeafGrid
from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.format import transcode, verify
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.runtime import native_io
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.utils.errors import FormatError, ModelMismatchError
from vqvdb_tpu_torch.vdb.grid import LeafGrid

torch.set_num_threads(2)

MODELS = Path(__file__).parent.parent / "models"
NEAR_TIE = 1e-5
ATOL = 1e-5
BATCH = 16


def smooth_field(channels=1, seed=0, shape=(32, 32, 24), blobs=4):
    rng = np.random.default_rng(seed)
    g = np.mgrid[tuple(slice(0, s) for s in shape)].astype(np.float32)
    dense = np.zeros(shape + (channels,), np.float32)
    for _ in range(blobs):
        c = rng.uniform(0, np.array(shape), 3)
        s = rng.uniform(3, 8)
        blob = np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / (2 * s * s))
        direction = np.ones(1) if channels == 1 else rng.uniform(-1, 1, channels)
        dense += blob[..., None] * direction.astype(np.float32)
    dense[np.abs(dense).max(-1) < 0.05] = 0
    return np.clip(dense, 0 if channels == 1 else -1, 1)


def _two_grids(dense, split=12):
    """The field's leaves as two named grids (for grid selection)."""
    full = LeafGrid.from_dense("x", dense)
    xf = np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32)
    return [LeafGrid("a", full.origins[:split], full.leaves[:split], transform=xf),
            LeafGrid("b", full.origins[split:], full.leaves[split:])]


def _jax_grids(grids):
    return [JaxLeafGrid(g.name, g.origins, g.leaves, transform=g.transform) for g in grids]


def _near_ties(scores):
    two = np.sort(scores, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))


def _stage_scores(jcodec, jparams, jcfg, leaves, ref_idx):
    """The JAX-side scores that decided each stage of `ref_idx` [N, S]."""
    x = jnp.asarray(leaves)
    if jcodec._score_mc is not None:
        if jcodec._folded_down is not None:
            h = jvqvae.encoder_features_packed_down(
                jparams.encoder, jcodec._folded_down, x, jcfg,
                fuse_rb16=jcodec.ccfg.fuse_rb16 and jcfg.variant == "scalar")
        else:
            h = jvqvae.encoder_features(jparams.encoder, x, jcfg)
        m, c = jcodec._score_mc
        return [np.asarray(h).reshape(-1, h.shape[-1]) @ np.asarray(m) + np.asarray(c)]
    res = jvqvae.encoder_apply(jparams.encoder, x, jcfg).reshape(-1, jcfg.embedding_dim)
    out = []
    for s in range(jcfg.num_quantizers):
        e = jparams.vq.embedding[s]
        out.append(np.asarray(jnp.sum(e * e, axis=1)[None] - 2.0 * res @ e.T))
        res = res - jquantizer.dequantize(jnp.asarray(ref_idx[:, s].astype(np.int32)), e)
    return out


def _read(path):
    """Every grid of a file: {name: (indices, origins)}."""
    out = {}
    with VqvdbReader(path) as r:
        for meta, batches in r.iter_grids(BATCH):
            idx, org = zip(*batches)
            out[meta.name] = (np.concatenate(idx), np.concatenate(org))
    return out


def _assert_indices_match(ours, theirs, jcodec, jparams, jcfg, grids):
    """Both files' indices, grid by grid: equal except near-ties. Returns the
    number of rows that differ."""
    a, b = _read(ours), _read(theirs)
    assert list(a) == list(b) == [g.name for g in grids]
    differ = 0
    s = jcfg.num_quantizers
    for g in grids:
        got, ref = a[g.name][0].reshape(-1, s), b[g.name][0].reshape(-1, s)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(a[g.name][1], b[g.name][1])
        alive = np.ones(got.shape[0], bool)
        for stage, scores in enumerate(_stage_scores(jcodec, jparams, jcfg, g.leaves, ref)):
            bad = alive & (got[:, stage] != ref[:, stage])
            off = bad & ~_near_ties(scores)
            assert not off.any(), f"{g.name} stage {stage}: {int(off.sum())} rows off near-ties"
            alive &= ~bad
        differ += int((~alive).sum())
    return differ


def _codecs(tree, cfg, jparams, jcfg, **opts):
    opts = dict(batch_size=BATCH, compute_dtype="float32", **opts)
    return (VQCodec(tree, cfg, CodecConfig(**opts), device="cpu"),
            JaxCodec(jparams, jcfg, JaxCodecConfig(**opts)))


# ---------------------------------------------------------------------------
# The flagship on the v6 int8 tier: one pair of files for several tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def jax_native_lz4(tmp_path_factory):
    """The JAX package's native library, loaded in this process. Its loader
    builds it with `native/build.sh` straight into place and, if it cannot
    load it, keeps its pure-Python LZ4 for the rest of the process: valid
    blocks, but not the native encoder's bytes. Under parallel test workers
    one worker can load while another's build is still writing the file
    ("file too short"), and a v5-lz4 transcode then differs from the port's
    by a few bytes. Where that happened, load a private copy built from the
    same source, written to a temporary name and renamed into place."""
    with pytest.MonkeyPatch.context() as mp:
        if jnative.backend() != "native":
            lib = tmp_path_factory.mktemp("jax_native") / "libvqvdb_native.so"
            native_io._build(lib)
            mp.setattr(jnative, "_LIB_PATH", lib)
            mp.setattr(jnative, "_tried", False)
            mp.setattr(jnative, "_lib", None)
        assert jnative.backend() == "native"
        yield


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flagship")
    tree, cfg = load_model(MODELS / "scalar.vqmodel")
    jparams, jcfg = jax_load_model(MODELS / "scalar.vqmodel")
    codec, jcodec = _codecs(tree, cfg, jparams, jcfg)
    grids = _two_grids(smooth_field()[..., 0])
    assert grids[1].num_leaves > BATCH
    ours, theirs = tmp / "ours.vqvdb", tmp / "theirs.vqvdb"
    stats = codec.compress(grids, ours, residual="int8")
    jcodec.compress(_jax_grids(grids), theirs, residual="int8")
    assert stats["leaves"] == sum(g.num_leaves for g in grids)
    assert set(stats["host_seconds"]) == {"quantize_residual", "write_frames"}
    return dict(codec=codec, jcodec=jcodec, jparams=jparams, jcfg=jcfg, grids=grids,
                ours=ours, theirs=theirs, tmp=tmp)


def test_flagship_v6_int8_matches_jax_and_bound_holds(flagship):
    f = flagship
    differ = _assert_indices_match(f["ours"], f["theirs"], f["jcodec"], f["jparams"],
                                   f["jcfg"], f["grids"])
    print(f"flagship v6: {differ} rows differ on near-ties")
    report = verify.verify_roundtrip(f["ours"], f["codec"], f["grids"])
    assert report["ok"], report
    for row in report["grids"]:
        assert row["bound_ok"] and row["max_abs_err"] <= row["residual_bound"]
    # Each package reads both files; on the same file the corrected leaves
    # agree within ATOL (each corrects its own reconstruction).
    for path in (f["ours"], f["theirs"]):
        mine, stats = f["codec"].decompress(path)
        want, _ = f["jcodec"].decompress(path)
        assert [g.name for g in mine] == [g.name for g in want] == ["a", "b"]
        assert stats["host_seconds"]["apply_residual"] > 0
        for m, w, src in zip(mine, want, f["grids"]):
            np.testing.assert_array_equal(m.origins, w.origins)
            np.testing.assert_array_equal(m.transform, src.transform)
            np.testing.assert_allclose(m.leaves, w.leaves, atol=ATOL)
            assert np.abs(m.leaves - src.leaves).max() < 2e-3


def test_decode_stream_and_selection_match_jax(flagship):
    f = flagship
    box = ((0, 0, 0), (17, 32, 12))
    for kw in (dict(grids="b"), dict(bbox=box), dict(grids=["a"], bbox=box),
               dict(grids="nothing")):
        mine = list(f["codec"].decode_stream(f["ours"], **kw))
        want = list(f["jcodec"].decode_stream(f["ours"], **kw))
        assert len(mine) == len(want)
        for (ma, la, oa), (mb, lb, ob) in zip(mine, want):
            assert ma.name == mb.name and la.shape == lb.shape
            np.testing.assert_array_equal(oa, ob)
            np.testing.assert_allclose(la, lb, atol=ATOL)
        got, _ = f["codec"].decompress(f["ours"], **kw)
        ref, _ = f["jcodec"].decompress(f["ours"], **kw)
        assert [g.name for g in got] == [g.name for g in ref]
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.origins, b.origins)
            np.testing.assert_allclose(a.leaves, b.leaves, atol=ATOL)
    # The bbox selection is re-packed into full batches, and every yielded
    # array belongs to the caller (no view of a reused buffer).
    batches = list(f["codec"].decode_stream(f["ours"], bbox=((-8, -8, -8), (64, 64, 64))))
    for name in ("a", "b"):
        sizes = [b[1].shape[0] for b in batches if b[0].name == name]
        assert all(n == BATCH for n in sizes[:-1]) and 0 < sizes[-1] <= BATCH
    assert batches[0][1].flags.owndata
    whole, _ = f["codec"].decompress(f["ours"])
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches if b[0].name == "a"]),
                                  whole[0].leaves)


class _Stream:
    """A grid read lazily, in pieces of `piece` leaves."""

    def __init__(self, grid, piece):
        self.grid, self.piece = grid, piece
        self.name, self.transform = grid.name, grid.transform
        self.num_leaves, self.channels, self.origins = (grid.num_leaves, grid.channels,
                                                        grid.origins)

    def leaf_batches(self, batch_size):
        for s in range(0, self.num_leaves, self.piece):
            yield self.grid.leaves[s: s + self.piece]


@pytest.mark.parametrize("opts", [dict(), dict(format_version=5, compression="lz4"),
                                  dict(residual="int8", residual_tol=1e-3)])
def test_compress_stream_byte_identical_to_compress(flagship, opts):
    f = flagship
    a, b = f["tmp"] / "c.vqvdb", f["tmp"] / "s.vqvdb"
    f["codec"].compress(f["grids"], a, **opts)
    stats = f["codec"].compress_stream([_Stream(g, 7) for g in f["grids"]], b, **opts)
    assert a.read_bytes() == b.read_bytes()
    assert stats["leaves"] == sum(g.num_leaves for g in f["grids"]) and not stats["aborted"]
    with pytest.raises(ValueError):
        short = _Stream(f["grids"][0], 7)
        short.num_leaves += 1
        f["codec"].compress_stream(short, b)


def test_transcode_and_verify_return_the_jax_dicts(flagship):
    f = flagship
    tmp = f["tmp"]
    for kw in (dict(version=5, compression="lz4", drop_residual=True),
               dict(version=6, compression="lzma"), dict(grids="b"),
               dict(version=4, drop_residual=True)):
        mine = transcode.transcode(f["ours"], tmp / "t_port.vqvdb", **kw)
        want = jtranscode.transcode(f["ours"], tmp / "t_jax.vqvdb", **kw)
        assert mine == want
        assert (tmp / "t_port.vqvdb").read_bytes() == (tmp / "t_jax.vqvdb").read_bytes()
    dropped = _read(tmp / "t_port.vqvdb")
    for name, (idx, org) in _read(f["ours"]).items():
        np.testing.assert_array_equal(dropped[name][0], idx)
    for mod, err in ((transcode, FormatError), (jtranscode, ValueError)):
        with pytest.raises(err):  # dropping fidelity without asking
            mod.transcode(f["ours"], tmp / "t.vqvdb", version=5)
        with pytest.raises(err):
            mod.transcode(f["ours"], tmp / "t.vqvdb", grids="nothing")

    cut = tmp / "cut.vqvdb"
    cut.write_bytes(f["ours"].read_bytes()[:-100])
    for path in (f["ours"], cut, tmp / "t_port.vqvdb"):
        mine, want = verify.verify_container(path), jverify.verify_container(path)
        assert mine == want
    assert not verify.verify_container(cut)["ok"]
    mine = verify.verify_roundtrip(f["ours"], f["codec"], f["grids"][1:])
    want = jverify.verify_roundtrip(f["ours"], f["jcodec"], _jax_grids(f["grids"][1:]))
    _assert_same_report(mine, want)
    assert not mine["ok"]  # grid "a" has no source here
    assert verify.verify_roundtrip(cut, f["codec"], f["grids"]) == \
        jverify.verify_roundtrip(cut, f["jcodec"], _jax_grids(f["grids"]))


def _assert_same_report(a, b):
    """Reports equal, their floats within 1e-3 relative (each package
    measures its own decode)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_report(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_report(x, y)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-3, abs=1e-7)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# The other tiers and codebook sizes
# ---------------------------------------------------------------------------

def test_rvq2_v6_f16_matches_jax(tmp_path):
    tree, cfg = load_model(MODELS / "scalar_rvq2.vqmodel")
    jparams, jcfg = jax_load_model(MODELS / "scalar_rvq2.vqmodel")
    codec, jcodec = _codecs(tree, cfg, jparams, jcfg)
    grids = _two_grids(smooth_field(seed=1, shape=(24, 24, 16))[..., 0], split=10)
    ours, theirs = tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb"
    codec.compress(grids, ours, residual="f16", compression="lz4")
    jcodec.compress(_jax_grids(grids), theirs, residual="f16", compression="lz4")
    _assert_indices_match(ours, theirs, jcodec, jparams, jcfg, grids)
    mine, _ = codec.decompress(ours)
    want, _ = jcodec.decompress(ours)
    for m, w, g, (idx, _) in zip(mine, want, grids, _read(ours).values()):
        np.testing.assert_allclose(m.leaves, w.leaves, atol=ATOL)
        # f16 tier: one half-precision rounding of the error
        err = np.abs(g.leaves - codec.decode_indices(idx))
        assert (np.abs(m.leaves - g.leaves) <= err * 2.0 ** -10 + 1e-6).all()
    with pytest.raises(ModelMismatchError):  # a residual stream of another width
        VQCodec(*load_model(MODELS / "vec3.vqmodel"), CodecConfig(batch_size=BATCH),
                device="cpu").decompress(ours)


@pytest.mark.parametrize("name", ["narrow_k512", "vec3_k4096"])
def test_large_codebooks_use_v4_and_u16(tmp_path, rng, name):
    """A narrow packed K=512 model, and the reference notebook's vec3
    configuration (K=4096, D=64): v4 files equal except near-tie rows, u16
    indices with codes above 255, each package reads the other's file."""
    if name == "narrow_k512":
        kw = dict(embedding_dim=16, num_embeddings=512, encoder_arch="packed")
        grids = _two_grids(smooth_field(seed=2, shape=(24, 24, 16))[..., 0], split=12)
    else:
        kw = dict(in_channels=3, embedding_dim=64, num_embeddings=4096)
        grids = [LeafGrid("vel", (np.arange(60).reshape(20, 3) * 8).astype(np.int32),
                          rng.random((20, 8, 8, 8, 3), np.float32) * 2 - 1)]
    jcfg = JaxModelConfig(**kw)
    jparams = init_vqvae_params(jax.random.key(5), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    codec, jcodec = _codecs(tree, ModelConfig(**kw), jparams, jcfg)
    ours, theirs = tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb"
    codec.compress(grids, ours)
    jcodec.compress(_jax_grids(grids), theirs)
    with VqvdbReader(ours) as r:
        assert r.version == 4 and r.num_embeddings == kw["num_embeddings"]
    differ = _assert_indices_match(ours, theirs, jcodec, jparams, jcfg, grids)
    a, b = (np.frombuffer(p.read_bytes(), np.uint8) for p in (ours, theirs))
    assert a.shape == b.shape and (a != b).sum() <= 2 * differ
    idx = np.concatenate([i for i, _ in _read(ours).values()])
    assert idx.dtype == np.uint16 and idx.max() > 255
    direct = codec.encode_leaves(grids[0].leaves)
    assert direct.dtype == np.uint16
    np.testing.assert_array_equal(direct, _read(ours)[grids[0].name][0])
    for path in (ours, theirs):
        mine, _ = codec.decompress(path)
        want, _ = jcodec.decompress(path)
        for m, w in zip(mine, want):
            np.testing.assert_array_equal(m.origins, w.origins)
            np.testing.assert_allclose(m.leaves, w.leaves, atol=ATOL)
    with pytest.raises(ValueError, match="requires"):
        codec.compress(grids, tmp_path / "v3.vqvdb", format_version=3)


def test_u16_indices_above_32767_round_trip(tmp_path):
    """Codes past the int16 range ride the pinned buffers as u16 bits: the
    flagship's codes placed at 32768 + i (the rows below pushed far away)
    encode to its own indices + 32768 and decode to its own leaves."""
    tree, cfg = load_model(MODELS / "scalar.vqmodel")
    e = tree["vq"]["embedding"]
    k = 32768 + e.shape[0]
    big = np.concatenate([np.tile(e + 100.0, (128, 1)), e]).astype(np.float32)
    grown = dict(tree, vq=dict(tree["vq"], embedding=big))
    opts = CodecConfig(batch_size=BATCH, compute_dtype="float32")
    base = VQCodec(tree, cfg, opts, device="cpu")
    codec = VQCodec(grown, dataclasses.replace(cfg, num_embeddings=k), opts, device="cpu")
    leaves = LeafGrid.from_dense("d", smooth_field(seed=3, shape=(16, 16, 24))[..., 0]).leaves
    want = base.encode_leaves(leaves)
    got = codec.encode_leaves(leaves)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want.astype(np.uint16) + 32768)
    np.testing.assert_array_equal(codec.decode_indices(got), base.decode_indices(want))
    grid = LeafGrid("d", (np.arange(3 * len(leaves)).reshape(-1, 3) * 8).astype(np.int32),
                    leaves)
    codec.compress(grid, tmp_path / "big.vqvdb", format_version=5, compression="lz4")
    np.testing.assert_array_equal(_read(tmp_path / "big.vqvdb")["d"][0], got)
