"""The port's `.vqvdb` v4/v5/v6 tiers, LZ4 shim and residual math against
the JAX package's, on the CPU.

Fed the same (indices, origins, scales, residual) arrays, the two writers
must produce byte-identical files, and each package reads the other's. zlib
and lzma bytes depend on the library version, so files are compared only
within one process. LZ4 bytes depend on the encoder: the JAX package must
run its native codec (the same `native/vqvdb_native.cpp` the port builds),
which the tests assert (`jax_native_lz4` of test_torch_port_codec_tiers.py
makes sure it does under parallel workers). Every error the JAX reader and writer raise is
mirrored: both packages raise the same class. The residual math must be
bit-equal to the JAX package's.
"""

import struct

import numpy as np
import pytest

from vqvdb_tpu.format import vqvdb as jfmt
from vqvdb_tpu.runtime import native_io as jnative
from vqvdb_tpu.runtime import residual as jres
from vqvdb_tpu_torch.format import vqvdb as fmt
from vqvdb_tpu_torch.runtime import native_io, residual
from vqvdb_tpu_torch.utils.errors import FormatError, VersionError
from vqvdb_tpu.utils.errors import FormatError as JaxFormatError
from vqvdb_tpu.utils.errors import VersionError as JaxVersionError

from test_torch_port_codec_tiers import jax_native_lz4  # noqa: F401  (autouse)

# (grid name, leaves, residual mode) of every file: an empty grid and a
# residual-free grid beside residual ones where the version allows
GRIDS = (("density", 37, True), ("empty", 0, True), ("temperature", 11, False))
# (label, version, compression, K, residual mode, tol)
CASES = [
    ("v4_k512", 4, "zlib", 512, None, None),
    ("v4_k256", 4, "zlib", 256, None, None),
    ("v5_zlib", 5, "zlib", 256, None, None),
    ("v5_lzma", 5, "lzma", 256, None, None),
    ("v5_lz4", 5, "lz4", 256, None, None),
    ("v5_lz4_k4096", 5, "lz4", 4096, None, None),
    ("v6_int8", 6, "zlib", 256, "int8", None),
    ("v6_int8_tol", 6, "lz4", 256, "int8", 2e-3),
    ("v6_f16", 6, "zlib", 256, "f16", None),
    ("v6_int8_k512_lzma", 6, "lzma", 512, "int8", None),
    ("v6_none", 6, "zlib", 256, None, None),
]


def _lattice_origins(rng, n):
    o = np.stack(np.unravel_index(rng.permutation(10 ** 3)[:n], (10,) * 3), 1)
    return (o * 8 - 40).astype(np.int32)


def _payload(rng, n, k, channels, mode, tol):
    """Indices (u8, or u16 with codes above 255), origins, and the residual
    of an error field quantized by the JAX package's own function (checked
    bit-equal to the port's in test_residual_math_bit_equal)."""
    idx = rng.integers(0, k, size=(n, 4, 4, 4)).astype(np.uint8 if k <= 256 else np.uint16)
    org = _lattice_origins(rng, n)
    scales = res = None
    if mode is not None and n == 0:  # the JAX function takes no empty batch
        scales = np.zeros(0, np.float32) if mode == "int8" else None
        res = np.zeros((0, 512 * channels), np.int8 if mode == "int8" else np.float16)
    elif mode is not None:
        err = (rng.standard_normal((n, 8, 8, 8, channels)) * 0.01).astype(np.float32)
        err[:2] *= 1e-3  # leaves already within tol: mostly zero codes
        scales, res = jres.quantize_residual(err, mode, tol)
    return idx, org, scales, res


def _write(mod, path, version, compression, k, data, channels=1):
    with mod.VqvdbWriter(path, version=version, compression=compression) as w:
        for (name, n, with_res), (idx, org, sc, res) in zip(GRIDS, data):
            mode = 0 if res is None or not with_res else (1 if sc is not None else 2)
            xf = np.eye(4, dtype=np.float32) * 0.25
            w.start_grid(mod.GridMetadata(name=name, num_embeddings=k, latent_shape=(4, 4, 4),
                                          total_blocks=n, transform=xf, residual_mode=mode,
                                          residual_channels=channels if mode else 0))
            for part in np.array_split(np.arange(n), 3):  # three frames, as batches
                if mode:
                    w.write_batch(idx[part], org[part], None if sc is None else sc[part],
                                  res[part])
                else:
                    w.write_batch(idx[part], org[part])
            w.end_grid()


def test_jax_side_runs_the_native_lz4():
    """Two valid LZ4 encoders need not agree byte for byte: the JAX package's
    native path and the port's shim build the same source."""
    assert jnative.backend() == "native"
    assert native_io.backend() == "native"
    raw = np.random.default_rng(0).integers(0, 9, 20000, dtype=np.uint8).tobytes()
    assert native_io.lz4_compress(raw) == jnative.lz4_compress(raw)


@pytest.mark.parametrize("label,version,compression,k,mode,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_files_byte_identical_and_cross_readable(rng, tmp_path, label, version,
                                                 compression, k, mode, tol):
    channels = 3 if mode == "f16" else 1
    data = [_payload(rng, n, k, channels, mode if with_res else None, tol)
            for _, n, with_res in GRIDS]
    ours, theirs = tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb"
    _write(fmt, ours, version, compression, k, data, channels)
    _write(jfmt, theirs, version, compression, k, data, channels)
    assert ours.read_bytes() == theirs.read_bytes()
    for reader in (fmt.VqvdbReader, jfmt.VqvdbReader):
        for path in (ours, theirs):
            with reader(path) as r:
                assert (r.version, r.num_embeddings, r.num_grids) == (version, k, len(GRIDS))
                for (name, n, _), want in zip(GRIDS, data):
                    meta = r.next_grid_metadata()
                    assert meta.name == name and meta.total_blocks == n
                    assert r.grid_codec == (compression if version >= 5 else None)
                    parts = []
                    while r.has_next():
                        parts.append(r.next_batch_residual(16))
                    got = [None if not parts or p[0] is None else np.concatenate(p)
                           for p in zip(*parts)] if parts else [None] * 4
                    if not n:
                        continue
                    assert got[0].dtype == (np.uint8 if k <= 256 else np.uint16)
                    np.testing.assert_array_equal(got[0], want[0])
                    np.testing.assert_array_equal(got[1], want[1])
                    if meta.residual_mode:
                        assert meta.residual_channels == channels
                        for a, b in zip(got[2:], want[2:]):
                            assert (a is None) == (b is None)
                            if a is not None:
                                assert a.tobytes() == b.tobytes()
                    else:
                        assert got[2] is None and got[3] is None


def test_skip_grid_payload_matches_jax(rng, tmp_path):
    """skip_grid_payload reports the same stored bytes and lands on the next
    grid, also after part of a framed grid was read."""
    for version, compression, mode in ((3, "zlib", None), (4, "zlib", None),
                                       (5, "lz4", None), (6, "zlib", "int8")):
        data = [_payload(rng, n, 256, 1, mode if w else None, None) for _, n, w in GRIDS]
        path = tmp_path / f"v{version}.vqvdb"
        _write(fmt, path, version, compression, 256, data)
        for mod in (fmt, jfmt):
            with mod.VqvdbReader(path) as r:
                skipped = []
                for i in range(len(GRIDS)):
                    r.next_grid_metadata()
                    if i == 0:
                        r.next_batch_residual(5)
                    skipped.append(r.skip_grid_payload())
                assert not r.has_next_grid()
            if mod is fmt:
                ours = skipped
        assert ours == skipped


def _v5_file(tmp_path, version=5, mode=None, compression="zlib", n=12):
    rng = np.random.default_rng(3)
    data = [_payload(rng, n, 256, 1, mode, None)]
    path = tmp_path / f"base{version}.vqvdb"
    with jfmt.VqvdbWriter(path, version=version, compression=compression) as w:
        idx, org, sc, res = data[0]
        w.start_grid(jfmt.GridMetadata("g", 256, (4, 4, 4), total_blocks=n,
                                       residual_mode={None: 0, "int8": 1, "f16": 2}[mode],
                                       residual_channels=0 if mode is None else 1))
        w.write_batch(idx[:5], org[:5], None if sc is None else sc[:5],
                      None if res is None else res[:5])
        w.write_batch(idx[5:], org[5:], None if sc is None else sc[5:],
                      None if res is None else res[5:])
    return path, path.read_bytes()


GRID_HEADER = 12 + 4 + 1 + 64 + 6 + 4  # file header, name "g", transform, shape, blocks


def _reader_errors(tmp_path):
    """(label, file bytes) of damaged files; reading each grid must raise."""
    path, v5 = _v5_file(tmp_path)
    _, v6 = _v5_file(tmp_path, 6, "int8")
    _, v6f = _v5_file(tmp_path, 6, "f16", "lz4")
    _, v4 = _v5_file(tmp_path, 4)
    first = GRID_HEADER + 1  # the first frame header of a v5 grid
    zero = bytearray(v5)
    zero[first: first + 4] = struct.pack("<I", 0)
    many = bytearray(v5)
    many[first: first + 4] = struct.pack("<I", 13)
    codec = bytearray(v5)
    codec[GRID_HEADER] = 9
    mode = bytearray(v6)
    mode[GRID_HEADER + 1] = 9
    lz4 = bytearray(v6f)
    lz4[first + 2 + 12 + 40] ^= 0xFF  # inside the first frame's blob
    v3_big = bytearray(v4)
    v3_big[5] = 3
    v3_big[7:11] = struct.pack("<I", 512)
    return [("v5_truncated", v5[:-5]), ("v6_truncated", v6[:-9]),
            ("v4_truncated", v4[:-3]), ("frame_count_zero", bytes(zero)),
            ("frame_count_past_grid", bytes(many)), ("bad_codec_byte", bytes(codec)),
            ("bad_residual_mode_byte", bytes(mode)), ("lz4_corrupt_frame", bytes(lz4)),
            ("v3_header_k512", bytes(v3_big)), ("bad_magic", b"VQVDX" + v5[5:]),
            ("version_9", v5[:5] + bytes([9]) + v5[6:]), ("short_header", v5[:7])]


def _read_all(mod, path):
    with mod.VqvdbReader(path) as r:
        while r.has_next_grid():
            r.next_grid_metadata()
            while r.has_next():
                r.next_batch_residual(4)


READER_CASES = ["v5_truncated", "v6_truncated", "v4_truncated", "frame_count_zero",
                "frame_count_past_grid", "bad_codec_byte", "bad_residual_mode_byte",
                "lz4_corrupt_frame", "v3_header_k512", "bad_magic", "version_9",
                "short_header"]


@pytest.mark.parametrize("case", READER_CASES)
def test_reader_errors_match_jax(tmp_path, case):
    raw = dict(_reader_errors(tmp_path))[case]
    path = tmp_path / "bad.vqvdb"
    path.write_bytes(raw)
    outcome = {}
    for mod, errs in ((fmt, (FormatError, VersionError)),
                      (jfmt, (JaxFormatError, JaxVersionError))):
        try:
            _read_all(mod, path)
            outcome[mod] = None
        except errs as e:
            outcome[mod] = type(e).__name__
    if case == "lz4_corrupt_frame":  # a flip may still decode to the right size
        assert outcome[fmt] == outcome[jfmt]
    else:
        assert outcome[fmt] is not None and outcome[fmt] == outcome[jfmt], outcome


def _writer_error(mod, tmp_path, case):
    rng = np.random.default_rng(1)
    idx, org, sc, res = _payload(rng, 4, 256, 1, "int8", None)
    res_meta = mod.GridMetadata("g", 256, (4, 4, 4), total_blocks=4, residual_mode=1,
                                residual_channels=1)
    plain = mod.GridMetadata("g", 256, (4, 4, 4), total_blocks=4)
    path = tmp_path / f"w_{case}.vqvdb"
    if case == "version_7":
        mod.VqvdbWriter(path, version=7)
    elif case == "unknown_compression":
        mod.VqvdbWriter(path, version=5, compression="zstd")
    elif case == "meta_channels_zero":
        mod.GridMetadata("g", 256, (4, 4, 4), total_blocks=1, residual_mode=1,
                         residual_channels=0)
    elif case == "meta_mode_7":
        mod.GridMetadata("g", 256, (4, 4, 4), total_blocks=1, residual_mode=7,
                         residual_channels=1)
    with mod.VqvdbWriter(path, version=3 if case == "v3_k512" else
                         5 if case == "residual_on_v5" else 6) as w:
        if case == "v3_k512":
            w.start_grid(mod.GridMetadata("g", 512, (4, 4, 4), total_blocks=4))
        elif case == "residual_on_v5":
            w.start_grid(res_meta)
        elif case == "residual_on_plain_grid":
            w.start_grid(plain)
            w.write_batch(idx, org, sc, res)
        elif case in ("missing_residual", "missing_scales", "residual_width", "scale_count"):
            w.start_grid(res_meta)
            args = {"missing_residual": (None, None), "missing_scales": (None, res),
                    "residual_width": (sc, res[:, :256]), "scale_count": (sc[:3], res)}[case]
            w.write_batch(idx, org, *args)
        elif case == "declared_vs_written":
            w.start_grid(plain)
            w.write_batch(idx[:2], org[:2])
        elif case == "inconsistent_k":
            w.start_grid(plain)
            w.write_batch(idx, org)
            w.end_grid()
            w.start_grid(mod.GridMetadata("h", 512, (4, 4, 4), total_blocks=4))


WRITER_CASES = ["version_7", "unknown_compression", "meta_channels_zero", "meta_mode_7",
                "v3_k512", "residual_on_v5", "residual_on_plain_grid", "missing_residual",
                "missing_scales", "residual_width", "scale_count", "declared_vs_written",
                "inconsistent_k"]


@pytest.mark.parametrize("case", WRITER_CASES)
def test_writer_errors_match_jax(tmp_path, case):
    names = []
    for mod, errs in ((fmt, (FormatError, VersionError)),
                      (jfmt, (JaxFormatError, JaxVersionError))):
        with pytest.raises(errs) as e:
            _writer_error(mod, tmp_path, case)
        names.append(type(e.value).__name__)
    assert names[0] == names[1]


@pytest.mark.parametrize("mode,tol", [("int8", None), ("int8", 1e-3), ("int8", 0.5),
                                      ("f16", None)])
def test_residual_math_bit_equal(rng, mode, tol):
    err = (rng.standard_normal((9, 8, 8, 8, 3)) * 0.02).astype(np.float32)
    err[0] = 0.0  # an exact leaf: the scale floor
    err[1, 0, 0, 0, 0] = 70000.0  # beyond f16's range
    err[2] *= 1e-6
    with np.errstate(over="ignore"):
        ours = residual.quantize_residual(err, mode, tol)
        theirs = jres.quantize_residual(err, mode, tol)
    for a, b in zip(ours, theirs):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rec = (rng.random((9, 8, 8, 8, 3)) - 0.5).astype(np.float32)
    got = residual.apply_residual(rec.copy(), *ours)
    want = jres.apply_residual(rec.copy(), *theirs)
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        residual.quantize_residual(err, "int4")
    with pytest.raises(ValueError):
        residual.quantize_residual(err, "f16", 1e-3)


@pytest.mark.parametrize("k", [256, 4096])
def test_write_single_grid_matches_jax(rng, tmp_path, k):
    """write_single_grid: with u8 indices (K=256) the file is byte-identical
    to the JAX package's and the port's reader reads it back; with u16
    indices (K=4096) both refuse v3 with the same FormatError and leave the
    same bytes behind."""
    idx, org, _, _ = _payload(rng, 23, k, 1, None, None)
    transform = np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32)
    ours, theirs = tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb"
    if k > 256:
        with pytest.raises(FormatError) as e:
            fmt.write_single_grid(ours, "density", idx, org, k)
        with pytest.raises(JaxFormatError) as je:
            jfmt.write_single_grid(theirs, "density", idx, org, k)
        assert str(e.value) == str(je.value)
        assert ours.read_bytes() == theirs.read_bytes()
        return
    fmt.write_single_grid(ours, "density", idx, org, k, transform)
    jfmt.write_single_grid(theirs, "density", idx, org, k, transform)
    assert ours.read_bytes() == theirs.read_bytes()
    with fmt.VqvdbReader(ours) as r:
        meta, got_idx, got_org = r.read_grid()
        assert not r.has_next_grid()
    assert (meta.name, meta.num_embeddings, meta.latent_shape) == ("density", k, (4, 4, 4))
    np.testing.assert_array_equal(meta.transform, transform)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_org, org)
