"""The port's OpenVDB `.vdb` I/O and blosc codec against the JAX package's.

`vqvdb_tpu_torch/vdb/openvdb_io.py` and `vdb/blosc.py` are numpy-only
copies of the JAX package's modules. Here both packages write the same
grids: the files must be byte-identical (the 36-byte UUID of the header
fixed in both) for every compression mode, half floats and vec3 grids;
each package reads the other's files exactly; blosc chunks cross in both
directions, and against the system's c-blosc where it is installed. The
leaf streams equal `read_vdb`, and a streamed encode of a `.vdb` writes the
file `compress` writes, byte for byte.
"""

import ctypes
import ctypes.util
import uuid

import numpy as np
import pytest
import torch

from vqvdb_tpu.vdb import blosc as jax_blosc
from vqvdb_tpu.vdb import openvdb_io as jax_io
from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.utils.errors import FormatError
from vqvdb_tpu_torch.vdb import blosc
from vqvdb_tpu_torch.vdb import openvdb_io as io
from vqvdb_tpu_torch.vdb.grid import LeafGrid

torch.set_num_threads(2)

COMPRESSIONS = [io.COMPRESS_NONE, io.COMPRESS_ZIP, io.COMPRESS_ACTIVE_MASK,
                io.COMPRESS_ZIP | io.COMPRESS_ACTIVE_MASK, io.COMPRESS_BLOSC,
                io.COMPRESS_BLOSC | io.COMPRESS_ACTIVE_MASK]


@pytest.fixture(autouse=True)
def fixed_uuid(monkeypatch):
    """Both writers draw the header's UUID from uuid.uuid4."""
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0x1234))


def _grid_arrays(rng, n_leaves, comps, masked):
    pool = rng.choice(40, size=(4 * n_leaves, 3), replace=True) * 8 - 160
    pool[n_leaves // 2:, 0] += 4096  # a second root child
    origins = np.unique(pool, axis=0)[:n_leaves].astype(np.int32)
    shape = (len(origins), 8, 8, 8) + ((comps,) if comps > 1 else ())
    leaves = rng.random(shape, np.float32)
    leaves[leaves < 0.3] = 0.0
    masks = None
    if masked:
        masks = rng.integers(0, 256, (len(origins), 64), dtype=np.uint8)
        masks[:, 0] |= 1
    return origins, leaves, masks


def _grids(mod, arrays, value_type, background=0.0, name="density", tiles=()):
    origins, leaves, masks = arrays
    bg = background if value_type == "float" else np.full(3, background, np.float32)
    return mod.VdbGrid(name=name, value_type=value_type, origins=origins, leaves=leaves,
                       leaf_masks=masks, background=bg, tiles=list(tiles))


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("value_type,half", [("float", False), ("float", True),
                                             ("vec3s", False), ("vec3s", True)])
def test_vdb_bytes_identical_and_read_across(tmp_path, rng, compression, value_type, half):
    arrays = _grid_arrays(rng, 11, 1 if value_type == "float" else 3, masked=True)
    tile = (np.array([4096 + 512, 0, 0], np.int32), 8, np.float32(0.25), True)
    ours, theirs = tmp_path / "ours.vdb", tmp_path / "theirs.vdb"
    io.write_vdb(ours, [_grids(io, arrays, value_type, 0.5)], compression=compression,
                 half=half)
    jax_io.write_vdb(theirs, [_grids(jax_io, arrays, value_type, 0.5)],
                     compression=compression, half=half)
    assert ours.read_bytes() == theirs.read_bytes()
    if value_type == "float":  # tiles too
        io.write_vdb(ours, [_grids(io, arrays, value_type, tiles=[io.VdbTile(*tile)])],
                     compression=compression)
        jax_io.write_vdb(theirs, [_grids(jax_io, arrays, value_type,
                                         tiles=[jax_io.VdbTile(*tile)])],
                         compression=compression)
        assert ours.read_bytes() == theirs.read_bytes()
    # Each package reads the other's file as the other reads it.
    (a,), (b,) = io.read_vdb(theirs), jax_io.read_vdb(ours)
    for field in ("origins", "leaves", "leaf_masks", "transform"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.name, a.value_type, a.saved_as_half) == (b.name, b.value_type, b.saved_as_half)
    assert io.read_vdb_info(ours) == jax_io.read_vdb_info(theirs)


def test_leafgrid_files_identical_and_bridge(tmp_path, rng):
    """write_vdb_leafgrids of the same LeafGrids (scalar and vec3, several
    grids, negative origins, a transform) -> the same bytes; the LeafGrids
    read back equal the JAX package's, with tiles dropped alike."""
    from vqvdb_tpu.vdb.grid import LeafGrid as JaxLeafGrid

    tf = np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32)
    tf[:3, 3] = [1.0, -2.0, 3.0]
    specs = []
    for name, comps in (("density", 1), ("vel", 3)):
        origins, leaves, _ = _grid_arrays(rng, 9, comps, masked=False)
        specs.append(dict(name=name, origins=origins, leaves=leaves, transform=tf,
                          background=0.0))
    ours, theirs = tmp_path / "ours.vdb", tmp_path / "theirs.vdb"
    io.write_vdb_leafgrids(ours, [LeafGrid(**s) for s in specs])
    jax_io.write_vdb_leafgrids(theirs, [JaxLeafGrid(**s) for s in specs])
    assert ours.read_bytes() == theirs.read_bytes()
    got, want = io.read_vdb_leafgrids(ours), jax_io.read_vdb_leafgrids(ours)
    assert [g.name for g in got] == [g.name for g in want] == ["density", "vel"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.origins, w.origins)
        np.testing.assert_array_equal(g.leaves, w.leaves)
        np.testing.assert_array_equal(g.transform, w.transform)
        assert g.dropped_tiles == w.dropped_tiles == 0
    big = io.VdbTile(np.array([128, 0, 0], np.int32), 128, np.float32(1.0), True)
    leaf = io.VdbTile(np.array([64, 0, 0], np.int32), 8, np.float32(0.25), True)
    g = _grids(io, _grid_arrays(rng, 5, 1, False), "float", tiles=[leaf, big])
    lg = io.vdbgrid_to_leafgrid(g)
    jg = jax_io.vdbgrid_to_leafgrid(_grids(jax_io, (g.origins, g.leaves, None), "float",
                                           tiles=[jax_io.VdbTile(t.origin, t.span, t.value,
                                                                 t.active)
                                                  for t in (leaf, big)]))
    np.testing.assert_array_equal(lg.origins, jg.origins)
    np.testing.assert_array_equal(lg.leaves, jg.leaves)
    assert lg.dropped_tiles == jg.dropped_tiles == 1


def _raised(read, path):
    try:
        read(path)
    except Exception as e:  # the type and text are compared across packages
        return type(e).__name__, str(e)
    return None


def test_malformed_files_raise_alike(tmp_path, rng):
    path = tmp_path / "g.vdb"
    io.write_vdb(path, [_grids(io, _grid_arrays(rng, 4, 1, False), "float")])
    raw = path.read_bytes()
    for bad in (b"JUNK" + raw[4:], raw[:10], raw[:60], raw[: len(raw) // 2], raw[:-3]):
        path.write_bytes(bad)
        got = _raised(io.read_vdb, path)
        assert got is not None and got == _raised(jax_io.read_vdb, path)
    path.write_bytes(b"JUNK" + raw[4:])
    with pytest.raises(FormatError, match="magic"):
        io.read_vdb(path)


@pytest.mark.parametrize("comps,half", [(1, False), (1, True), (3, False)])
def test_streams_equal_read_vdb(tmp_path, rng, comps, half):
    arrays = _grid_arrays(rng, 40, comps, masked=False)
    tile = io.VdbTile(np.array([4096 + 1024, 0, 0], np.int32), 8, np.float32(0.75), True)
    g = _grids(io, arrays, "float" if comps == 1 else "vec3s",
               tiles=[tile] if comps == 1 else ())
    path = tmp_path / "s.vdb"
    io.write_vdb(path, [g, _grids(io, arrays, g.value_type, name="other")], half=half)
    full = io.read_vdb_leafgrids(path)
    streams = io.open_vdb_leaf_streams(path)
    theirs = jax_io.open_vdb_leaf_streams(path)
    assert [s.name for s in streams] == [s.name for s in theirs] == ["density", "other"]
    for grid, s, t in zip(full, streams, theirs):
        assert s.num_leaves == t.num_leaves == grid.num_leaves
        np.testing.assert_array_equal(s.origins, grid.origins)
        got = np.concatenate(list(s.leaf_batches(16)))
        np.testing.assert_array_equal(got, grid.leaves)
        np.testing.assert_array_equal(got, np.concatenate(list(t.leaf_batches(7))))
        assert max(b.shape[0] for b in s.leaf_batches(16)) <= 16
    only = io.open_vdb_leaf_streams(path, names="other")
    assert [s.name for s in only] == ["other"]


def test_streamed_vdb_encode_byte_identical_to_compress(tmp_path, rng):
    """compress_stream of the .vdb's leaf streams writes what compress of
    read_vdb_leafgrids writes: v3, v5-lz4 and v6 int8, the flagship at full
    width on the CPU."""
    tree, cfg = load_model(VQ_MODEL)
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=16, compute_dtype="float32"),
                    device="cpu")
    origins, leaves, _ = _grid_arrays(rng, 37, 1, masked=False)
    path = tmp_path / "e.vdb"
    io.write_vdb_leafgrids(path, [LeafGrid("density", origins, leaves)])
    grids = io.read_vdb_leafgrids(path)
    for kw in ({}, {"format_version": 5, "compression": "lz4"}, {"residual": "int8"}):
        a, b = tmp_path / "a.vqvdb", tmp_path / "b.vqvdb"
        codec.compress(grids, a, **kw)
        codec.compress_stream(io.open_vdb_leaf_streams(path), b, **kw)
        assert a.read_bytes() == b.read_bytes(), f"differs for {kw}"


VQ_MODEL = __import__("pathlib").Path(__file__).parent.parent / "models" / "scalar.vqmodel"


def _payloads():
    rng = np.random.default_rng(7)
    return [
        ("smooth_f32", np.cumsum(rng.standard_normal(4096).astype(np.float32) * 0.01)
         .tobytes(), 4),
        ("noise_f32", rng.standard_normal(1000).astype(np.float32).tobytes(), 4),
        ("zeros", bytes(8192), 4),
        ("f16_ramp", (np.arange(3000) % 97).astype(np.float16).tobytes(), 2),
        ("tiny", b"abcd" * 3, 4),
        ("odd_u8", rng.integers(0, 4, 10001).astype(np.uint8).tobytes(), 1),
        ("multiblock_f32", np.cumsum(rng.standard_normal(200_000).astype(np.float32) * 1e-3)
         .tobytes(), 4),
    ]


@pytest.mark.parametrize("name,data,typesize", _payloads())
@pytest.mark.parametrize("shuffle", [True, False])
def test_blosc_chunks_cross_between_packages(name, data, typesize, shuffle):
    ours = bytes(blosc.compress(data, typesize, shuffle=shuffle))
    assert ours == bytes(jax_blosc.compress(data, typesize, shuffle=shuffle))
    assert bytes(blosc.decompress(ours)) == data
    assert bytes(jax_blosc.decompress(ours)) == data
    assert blosc.openvdb_compress(data) == jax_blosc.openvdb_compress(data)


def _libblosc():
    found = ctypes.util.find_library("blosc")
    if not found:
        return None
    lib = ctypes.CDLL(found)
    lib.blosc_compress_ctx.restype = ctypes.c_int
    lib.blosc_compress_ctx.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.blosc_decompress_ctx.restype = ctypes.c_int
    lib.blosc_decompress_ctx.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_int]
    return lib


@pytest.mark.parametrize("codec", [b"lz4", b"zlib"])
def test_blosc_against_system_c_blosc(codec):
    """Where the system's c-blosc is installed (the library OpenVDB links),
    its chunks decode under the port and the port's under it."""
    lib = _libblosc()
    if lib is None:
        pytest.skip("system libblosc not available")
    for name, data, typesize in _payloads():
        dst = ctypes.create_string_buffer(len(data) + blosc.MAX_OVERHEAD + 64)
        n = lib.blosc_compress_ctx(9, 1, typesize, len(data), data, dst, len(dst), codec, 0, 1)
        assert n > 0
        assert bytes(blosc.decompress(dst.raw[:n])) == data, name
        mine = bytes(blosc.compress(data, typesize))
        out = ctypes.create_string_buffer(max(len(data), 1))
        assert lib.blosc_decompress_ctx(mine, out, len(data), 1) == len(data)
        assert out.raw[:len(data)] == data, name
