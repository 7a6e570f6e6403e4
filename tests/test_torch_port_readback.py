"""`VQCodec.decompress` reads each batch's decoded rows back straight into
the output grid (`runtime/codec.py`), on the CPU.

The grids it returns must hold the bits that `decode_indices` gives on the
file's indices (with the v6 correction added as `apply_residual` adds it),
with the same origins, names and transforms, however the file's grids are
selected and on a mesh; the grids must be the caller's own memory, which a
later call leaves alone. The file imports no JAX, so the card's tests can
import from it.
"""

from typing import List

import numpy as np
import pytest
import torch

from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_to_jax
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.models.vqvae import init_vqvae_params
from vqvdb_tpu_torch.parallel.mesh import make_mesh
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.runtime.residual import apply_residual
from vqvdb_tpu_torch.vdb.grid import LeafGrid

BATCH = 64
# Leaves of each grid: every one ends in a ragged batch, one has a single one.
SIZES = {"density": 150, "temperature": 70, "fuel": 20}
# Keeps the first 100 leaves along x of the grids at z 0 and 64, and nothing
# of the grid at z 128.
BBOX = ((0, 0, 0), (8 * 100 - 3, 10**6, 100))


def tiny_model():
    """A small reference-arch model (D=32, K=64) from the port's seeded
    initialiser, as the JAX-layout tree and its config."""
    cfg = ModelConfig(embedding_dim=32, num_embeddings=64)
    return params_to_jax(init_vqvae_params(torch.Generator().manual_seed(0), cfg)), cfg


def field(seed: int = 0, channels: int = 1) -> List[LeafGrid]:
    """Grid g of SIZES: leaves in a shuffled order along x at z = 64 g, each
    grid with its own transform."""
    rng = np.random.default_rng(seed)
    grids = []
    for g, (name, n) in enumerate(SIZES.items()):
        x = rng.permutation(n) * 8
        origins = np.stack([x, np.zeros(n), np.full(n, 64 * g)], 1).astype(np.int32)
        transform = np.diag([0.5 + g, 0.5 + g, 0.5 + g, 1.0]).astype(np.float32)
        grids.append(LeafGrid(name=name, origins=origins, transform=transform,
                              leaves=rng.random((n, 8, 8, 8, channels), np.float32)))
    return grids


def expected(codec: VQCodec, path, names=None, bbox=None):
    """(name, origins, leaves, transform) of each selected grid: the file's
    indices through `decode_indices`, the v6 correction added."""
    want = []
    with VqvdbReader(path) as r:
        while r.has_next_grid():
            meta = r.next_grid_metadata()
            parts = []
            while r.has_next():  # a framed (v6) file serves a frame at a time
                parts.append(r.next_batch_residual(meta.total_blocks))
            idx, org, scales, res = (None if p[0] is None else np.concatenate(p)
                                     for p in zip(*parts))
            if names is not None and meta.name not in names:
                continue
            if bbox is not None:
                keep = (np.all(org < np.asarray(bbox[1]), axis=1)
                        & np.all(org + 8 > np.asarray(bbox[0]), axis=1))
                idx, org = idx[keep], org[keep]
                scales, res = (None if a is None else a[keep] for a in (scales, res))
                if not keep.any():
                    continue
            leaves = codec.decode_indices(idx)
            apply_residual(leaves, scales, res)
            want.append((meta.name, org, leaves, meta.transform))
    return want


def assert_grids_equal(got: List[LeafGrid], want) -> None:
    assert [g.name for g in got] == [w[0] for w in want]
    for g, (name, origins, leaves, transform) in zip(got, want):
        np.testing.assert_array_equal(g.origins, origins, err_msg=name)
        np.testing.assert_array_equal(g.transform, transform, err_msg=name)
        assert g.leaves.shape == leaves.shape, name
        assert g.leaves.tobytes() == leaves.tobytes(), name


def codec_for(mesh: int = 0) -> VQCodec:
    tree, cfg = tiny_model()
    kw = {"mesh": make_mesh(mesh, device="cpu")} if mesh else {"device": "cpu"}
    return VQCodec(tree, cfg, CodecConfig(batch_size=BATCH, compute_dtype="float32"), **kw)


@pytest.mark.parametrize("case", ["v3", "grids", "bbox", "v6", "mesh2"])
def test_decompress_equals_decode_indices_of_the_file(tmp_path, case):
    codec = codec_for(2 if case == "mesh2" else 0)
    path = tmp_path / "f.vqvdb"
    codec.compress(field(), path, **({"residual": "int8"} if case == "v6" else {}))
    sel = {"grids": {"grids": ["fuel", "density"]}, "bbox": {"bbox": BBOX}}.get(case, {})
    got, stats = codec.decompress(path, **sel)
    want = expected(codec, path, sel.get("grids"), sel.get("bbox"))
    assert len(want) == {"grids": 2, "bbox": 2}.get(case, 3)
    assert_grids_equal(got, want)
    assert stats["leaves"] == sum(w[2].shape[0] for w in want)
    assert stats["direct_readback_share"] == 1.0
    assert stats["pinned_pool_growth"] == 0


def test_a_kept_grid_is_the_callers_own(tmp_path):
    """A grid kept from one decompress is not touched by the next, is
    writable, and shares no memory with the codec's buffers; the output
    placement is still timed as `host/scatter`, once a batch and once to
    assemble the grids."""
    codec = codec_for()
    a_path, b_path = tmp_path / "a.vqvdb", tmp_path / "b.vqvdb"
    codec.compress(field(seed=1), a_path)
    codec.compress(field(seed=2), b_path, residual="int8")
    codec.profiler.reset()
    (a, *_), a_stats = codec.decompress(a_path)
    batches = sum(-(-n // BATCH) for n in SIZES.values())
    assert codec.profiler.report()["host/scatter"]["count"] == batches + 1
    kept = a.leaves.copy()
    b_grids, b_stats = codec.decompress(b_path)
    assert a.leaves.tobytes() == kept.tobytes()
    assert a.leaves.flags.writeable
    a.leaves[0] = -1.0
    assert (a.leaves[0] == -1.0).all()
    buffers = [buf for stage in codec._slots["decode"] for slot in stage.slots
               for buf in slot.outs_np]
    assert buffers
    for grid in [a, *b_grids]:
        assert not any(np.shares_memory(grid.leaves, buf) for buf in buffers)
    assert not any(np.shares_memory(a.leaves, g.leaves) for g in b_grids)
    assert a_stats["direct_readback_share"] == b_stats["direct_readback_share"] == 1.0
    assert codec.profiler.report()["host/scatter"]["count"] == 2 * (batches + 1)
