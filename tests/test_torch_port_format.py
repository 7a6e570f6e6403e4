"""The port's `.vqvdb` v3 reader/writer and LeafGrid against the JAX
package's: the same indices give byte-identical files, each package reads
the other's, and the same dense volume gives the same leaves."""

import numpy as np
import pytest

from vqvdb_tpu.format import vqvdb as jfmt
from vqvdb_tpu.vdb import grid as jgrid
from vqvdb_tpu_torch.format import vqvdb as fmt
from vqvdb_tpu_torch.utils.errors import FormatError, VersionError
from vqvdb_tpu_torch.vdb import grid

GRIDS = [("density", 37), ("temperature", 5), ("empty", 0)]


def _grid_data(rng, n, latent=(4, 4, 4)):
    idx = rng.integers(0, 256, size=(n,) + latent, dtype=np.uint8)
    org = (rng.integers(-50, 50, size=(n, 3)) * 8).astype(np.int32)
    xf = np.eye(4, dtype=np.float32) * 0.5
    xf[3, 3] = 1.0
    return idx, org, xf


def _write(mod, path, data, abort_last=False):
    with mod.VqvdbWriter(path) as w:
        for (name, n), (idx, org, xf) in zip(GRIDS, data):
            w.start_grid(mod.GridMetadata(name=name, num_embeddings=256,
                                          latent_shape=idx.shape[1:],
                                          total_blocks=n, transform=xf))
            # two batches, as the codec writes them
            w.write_batch(idx[:10], org[:10])
            w.write_batch(idx[10:], org[10:])
            if abort_last and name == "density":
                w.abort_grid()
                return
            w.end_grid()


@pytest.mark.parametrize("abort", [False, True])
def test_files_byte_identical_and_cross_readable(rng, tmp_path, abort):
    _check_files(rng, tmp_path, abort, (4, 4, 4))


@pytest.mark.parametrize("abort", [False, True])
def test_rvq_files_byte_identical_and_cross_readable(rng, tmp_path, abort):
    """A two-stage residual-VQ grid: the 4-D latent shape (4,4,4,2)."""
    _check_files(rng, tmp_path, abort, (4, 4, 4, 2))


def _check_files(rng, tmp_path, abort, latent):
    data = [_grid_data(rng, n, latent) for _, n in GRIDS]
    ours, theirs = tmp_path / "ours.vqvdb", tmp_path / "theirs.vqvdb"
    _write(fmt, ours, data, abort)
    _write(jfmt, theirs, data, abort)
    assert ours.read_bytes() == theirs.read_bytes()
    for reader in (fmt.VqvdbReader, jfmt.VqvdbReader):
        for path in (ours, theirs):
            with reader(path) as r:
                assert r.num_embeddings == 256
                for (name, n), (idx, org, xf) in zip(GRIDS, data):
                    if not r.has_next_grid():
                        break
                    meta, got_idx, got_org = r.read_grid()
                    assert meta.name == name
                    assert tuple(meta.latent_shape) == latent
                    np.testing.assert_array_equal(meta.transform, xf)
                    np.testing.assert_array_equal(got_idx, idx)
                    np.testing.assert_array_equal(got_org, org)


def test_streaming_batches_and_errors(rng, tmp_path):
    data = [_grid_data(rng, n) for _, n in GRIDS]
    path = tmp_path / "a.vqvdb"
    _write(fmt, path, data)
    with fmt.VqvdbReader(path) as r:
        r.next_grid_metadata()
        got = []
        while r.has_next():
            idx, org = r.next_batch(16)
            assert idx.shape[0] <= 16 and org.shape == (idx.shape[0], 3)
            got.append(idx)
        np.testing.assert_array_equal(np.concatenate(got), data[0][0])
    # truncated payload
    raw = path.read_bytes()
    (tmp_path / "cut.vqvdb").write_bytes(raw[:-5])
    with fmt.VqvdbReader(tmp_path / "cut.vqvdb") as r:
        with pytest.raises(FormatError):
            while r.has_next_grid():
                r.read_grid()
    # declared-vs-written mismatch
    with pytest.raises(FormatError):
        with fmt.VqvdbWriter(tmp_path / "b.vqvdb") as w:
            w.start_grid(fmt.GridMetadata("g", 256, (4, 4, 4), total_blocks=3))
            w.write_batch(data[1][0][:2], data[1][1][:2])


def test_other_versions_raise(rng, tmp_path):
    with pytest.raises(VersionError):
        fmt.VqvdbWriter(tmp_path / "x.vqvdb", version=4)
    idx, org, _ = _grid_data(rng, 4)
    v4 = tmp_path / "v4.vqvdb"
    with jfmt.VqvdbWriter(v4, version=4) as w:
        w.start_grid(jfmt.GridMetadata("g", 256, (4, 4, 4), total_blocks=4))
        w.write_batch(idx, org)
    with pytest.raises(VersionError):
        fmt.VqvdbReader(v4)
    bad = tmp_path / "bad.vqvdb"
    bad.write_bytes(b"VQVDX" + v4.read_bytes()[5:])
    with pytest.raises(FormatError):
        fmt.VqvdbReader(bad)


@pytest.mark.parametrize("channels", [1, 3])
def test_leaf_grid_matches_jax(rng, channels):
    """from_dense on a shape that is not a multiple of 8, with an origin
    offset and a tolerance; to_dense back; psnr of a perturbed copy."""
    dense = rng.random((21, 16, 11, channels), dtype=np.float32)
    dense[dense < 0.97] = 0.0
    kw = dict(origin=(8, -16, 0), tolerance=0.01)
    got = grid.LeafGrid.from_dense("g", dense, **kw)
    ref = jgrid.LeafGrid.from_dense("g", dense, **kw)
    assert got.num_leaves == ref.num_leaves > 0 and got.channels == channels
    np.testing.assert_array_equal(got.origins, ref.origins)
    np.testing.assert_array_equal(got.leaves, ref.leaves)
    for a, b in zip(got.to_dense(), ref.to_dense()):
        np.testing.assert_array_equal(a, b)
    noisy = got.leaves + 0.01 * rng.standard_normal(got.leaves.shape).astype(np.float32)
    assert grid.psnr(noisy, got.leaves) == jgrid.psnr(noisy, got.leaves)
