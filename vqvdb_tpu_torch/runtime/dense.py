"""Dense volumes on the device <-> `.vqvdb` (counterpart of
`vqvdb_tpu/runtime/dense.py`).

The sparse paths (`VQCodec.decompress` + `LeafGrid.to_dense`, and
`LeafGrid.from_dense` + `VQCodec.compress`) move every leaf across the
host boundary: 2 KiB a scalar leaf, against 64 B of indices. These paths
keep the volume on the device for consumers that want it there (renderers,
simulators, learning pipelines):

  decode_to_dense    indices -> dense [X,Y,Z,C] on the codec's device. A
                     Python loop over fixed-size steps: each step is the
                     codec's own decode step at exactly `batch_size` leaves
                     (`VQCodec._decode_step`, so the same launches run on the
                     same rows as in `decompress`), then a row scatter
                     (`index_copy_`) into a [nB+1, 512*C] buffer whose last
                     row takes the padded rows. Only the indices (and a v6
                     correction stream) go up; nothing comes back.
  encode_from_dense  dense -> (indices, origins). The activity of each 8^3
                     block is reduced on the device and only the nB-long mask
                     comes back; the active blocks are gathered in
                     origin-major order and encoded step by step
                     (`VQCodec._encode_step`, the last step zero-padded as
                     `compress` pads it), and only the indices come back.

Neither loop waits for the device: the host enqueues every step and syncs
once, when the mask or the indices come back. The output of
`decode_to_dense` is a tensor on the codec's device, bit-equal to the
sparse path's `decompress` then `LeafGrid.to_dense`.

v6 grids are corrected on the device with the host's arithmetic
(`runtime/residual.py:apply_residual`): the int8 rows times their leaf's
scale, rounded, then added to the decoded rows, rounded. Two eager ops
round twice as numpy does; a fused multiply-add would round once and break
the bit equality on which the int8 bound rests.

Memory: the block buffer and the dense output each take X*Y*Z*C*4 bytes
(302 MB for a 512 x 512 x 288 scalar volume); `encode_from_dense` makes one
block-major copy of its input.

With a mesh codec (one process) the volume is cut into x-slabs of leaf
blocks, ceil(nx / size) block planes each: a leaf belongs to the device
that owns its slab (`owner = bi[:, 0] // nx_local`). Each device decodes and
scatters only its slab's leaves (v6 correction included) into its own slab
buffer, in steps of `batch_size`, and the slabs are joined on the codec's
first device; encode reduces activity and encodes active blocks slab by
slab on the slab's device. Slabs are x-major, so the joined volume and the
origin-major order of the encoded leaves are the single-device path's, bit
for bit. A multi-process mesh raises: these paths build host-global inputs;
use the file codec there.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vqvdb_tpu_torch.core.config import LEAF_DIM
from vqvdb_tpu_torch.format.vqvdb import GridMetadata, VqvdbReader, VqvdbWriter
from vqvdb_tpu_torch.utils.errors import ModelMismatchError, VqvdbError

PathLike = Union[str, Path]


def _mesh_devices(codec) -> List[torch.device]:
    """The devices the codec's dense paths run on, slab order: its mesh's,
    or its own device alone."""
    mesh = codec.mesh
    if mesh is None:
        return [codec.device]
    if mesh.multiprocess:
        raise VqvdbError("the dense paths build host-global inputs and run on a mesh "
                         "of one process; in a multi-process run use the file codec "
                         "paths or a mesh of this process's devices")
    return list(mesh.devices)


def _block_plan(origins: np.ndarray, lo: Optional[np.ndarray] = None,
                shape: Optional[Tuple[int, int, int]] = None):
    """(lo, block dims (nx, ny, nz), per-leaf linear block ids, per-leaf
    block coordinates). `lo` / `shape` (voxel units) pin the frame; by
    default it is the origins' bounding box."""
    origins = np.ascontiguousarray(origins, np.int32).reshape(-1, 3)
    if np.any(origins % LEAF_DIM):
        raise VqvdbError("leaf origins must be multiples of 8")
    if lo is None:
        lo = origins.min(axis=0) if origins.shape[0] else np.zeros(3, np.int32)
    lo = np.asarray(lo, np.int32)
    if np.any(lo % LEAF_DIM):
        raise VqvdbError("dense lower corner must be a multiple of 8")
    if shape is None:
        ext = (origins.max(axis=0) + LEAF_DIM if origins.shape[0] else lo) - lo
    else:
        ext = np.asarray(shape, np.int64)
        if np.any(ext % LEAF_DIM):
            raise VqvdbError("dense shape must be multiples of 8")
    bdims = tuple(int(e) // LEAF_DIM for e in ext)
    bi = (origins - lo) // LEAF_DIM
    if origins.shape[0] and (np.any(bi < 0) or np.any(bi >= np.array(bdims))):
        raise VqvdbError("leaf origins fall outside the dense bounds")
    bids = (np.ravel_multi_index((bi[:, 0], bi[:, 1], bi[:, 2]), bdims).astype(np.int64)
            if origins.shape[0] else np.zeros(0, np.int64))
    return lo, bdims, bids, bi.astype(np.int32)


def _pad_steps(arr: np.ndarray, bs: int, fill) -> np.ndarray:
    """[N, ...] -> [steps, bs, ...], padded with `fill` to whole steps."""
    n = arr.shape[0]
    steps = max(1, -(-n // bs))
    out = np.full((steps * bs,) + arr.shape[1:], fill, arr.dtype)
    out[:n] = arr
    return out.reshape((steps, bs) + arr.shape[1:])


def _residual_mode(scales, residual) -> Optional[str]:
    if residual is None:
        return None
    if residual.dtype == np.int8:
        if scales is None:
            raise VqvdbError("int8 residual stream requires per-leaf scales")
        return "int8"
    if residual.dtype == np.float16:
        return "f16"
    raise VqvdbError(f"unknown residual dtype {residual.dtype}")


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; u16 indices go up as int16 bits."""
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _scan_scatter(codec, buf: torch.Tensor, idx_steps: torch.Tensor,
                  bid_steps: torch.Tensor, sc_steps: Optional[torch.Tensor],
                  res_steps: Optional[torch.Tensor]) -> None:
    """Decode each step, correct it (v6) and scatter its rows into `buf`,
    in place. No step waits for the device."""
    for s in range(idx_steps.shape[0]):
        idx = idx_steps[s]
        if idx.dtype == torch.int16:  # u16 bits
            idx = idx.to(torch.int32) & 0xFFFF
        rows = codec._decode_step(idx).reshape(idx.shape[0], -1)
        if res_steps is not None:
            corr = res_steps[s].to(torch.float32)
            if sc_steps is not None:
                corr = corr * sc_steps[s][:, None]
            rows = rows + corr
        buf.index_copy_(0, bid_steps[s], rows)


def _blocks_to_dense(buf: torch.Tensor, n_blocks: int, bdims, c: int) -> torch.Tensor:
    nx, ny, nz = bdims
    ld = LEAF_DIM
    blocks = buf[:n_blocks].reshape(nx, ny, nz, ld, ld, ld, c)
    return blocks.permute(0, 3, 1, 4, 2, 5, 6).reshape(nx * ld, ny * ld, nz * ld, c)


def _to_blocks(dense: torch.Tensor) -> torch.Tensor:
    """[X,Y,Z,C] (multiples of 8) -> [nB, 512*C] leaf-major rows (a copy)."""
    x, y, z, c = dense.shape
    ld = LEAF_DIM
    blocks = dense.reshape(x // ld, ld, y // ld, ld, z // ld, ld, c)
    return blocks.permute(0, 2, 4, 1, 3, 5, 6).reshape(-1, ld ** 3 * c)


@torch.no_grad()
def decode_to_dense(
    codec,
    indices: np.ndarray,
    origins: np.ndarray,
    *,
    lo: Optional[Sequence[int]] = None,
    shape: Optional[Tuple[int, int, int]] = None,
    background: float = 0.0,
    scales: Optional[np.ndarray] = None,
    residual: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Decode [N,4,4,4] (or [N,4,4,4,S]) indices into a dense volume on the
    codec's device.

    Returns (dense f32 tensor [X,Y,Z,C] on the codec's device, the frame's
    lower corner in index space). `lo` / `shape` pin the frame; by default
    it is the origins' bounding box. Voxels of no leaf hold `background`.
    scales / residual: a v6 correction stream (per-leaf f32 scales + int8
    rows, or f16 rows), applied on the device with the host's arithmetic.
    With a mesh codec each device decodes its x-slab's leaves (module
    docstring); the volume is joined on the codec's first device.
    """
    devices = _mesh_devices(codec)
    indices = np.ascontiguousarray(indices, np.dtype(codec.mcfg.index_dtype))
    mode = _residual_mode(scales, residual)
    lo_arr, bdims, bids, bi = _block_plan(origins, None if lo is None else np.asarray(lo),
                                          shape)
    c = codec.mcfg.in_channels
    dev = codec.device
    if indices.shape[0] == 0:
        return torch.zeros((0, 0, 0, c), dtype=torch.float32, device=dev), lo_arr
    if indices.shape[0] != bids.shape[0]:
        raise VqvdbError(f"{indices.shape[0]} index rows vs {bids.shape[0]} origins")
    bs = codec.ccfg.batch_size
    nx, ny, nz = bdims
    nx_local = -(-nx // len(devices))
    n_local = nx_local * ny * nz
    owner = bi[:, 0] // nx_local
    local_bids = bids - owner.astype(np.int64) * n_local
    if mode is not None:
        res = np.ascontiguousarray(residual).reshape(residual.shape[0], -1)
    slabs = []
    for k, d in enumerate(devices):
        mine = owner == k

        def take(a):  # this slab's rows (all of them on one device: no copy)
            return a if len(devices) == 1 else a[mine]

        buf = torch.full((n_local + 1, LEAF_DIM ** 3 * c), float(background),
                         dtype=torch.float32, device=d)
        if mine.any():
            sc_steps = res_steps = None
            if mode == "int8":
                sc_steps = _upload(_pad_steps(take(np.ascontiguousarray(scales, np.float32)),
                                              bs, 0), d)
            if mode is not None:
                res_steps = _upload(_pad_steps(take(res), bs, 0), d)
            # Padded rows scatter into the last row (n_local), which is dropped.
            _scan_scatter(codec, buf, _upload(_pad_steps(take(indices), bs, 0), d),
                          _upload(_pad_steps(take(local_bids), bs, n_local), d),
                          sc_steps, res_steps)
        slabs.append(buf[:n_local])
    blocks = slabs[0] if len(slabs) == 1 else torch.cat([t.to(dev) for t in slabs])
    dense = _blocks_to_dense(blocks, nx_local * len(devices) * ny * nz,
                             (nx_local * len(devices), ny, nz), c)
    return dense[:nx * LEAF_DIM], lo_arr


@torch.no_grad()
def encode_from_dense(
    codec,
    dense: Union[np.ndarray, torch.Tensor],
    *,
    origin: Sequence[int] = (0, 0, 0),
    background: float = 0.0,
    tolerance: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparsify and encode a dense volume [X,Y,Z] or [X,Y,Z,C] (numpy, or a
    tensor on the codec's device) on the device.

    A block is active when any voxel differs from `background` by more than
    `tolerance`, as `LeafGrid.from_dense` decides; an extent that is no
    multiple of 8 is padded with `background`. Returns (indices [N,4,4,4]
    in the model's index dtype, origins [N,3] int32) as host arrays, in the
    origin-major order of `LeafGrid.from_dense`. With a mesh codec each
    device reduces and encodes its x-slab (module docstring)."""
    devices = _mesh_devices(codec)
    dev = codec.device
    if isinstance(dense, torch.Tensor):
        if dense.device != dev:
            raise VqvdbError(f"dense is on {dense.device}, the codec on {dev}")
        vol = dense.to(torch.float32)
    else:
        vol = torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(dev)
    if vol.dim() == 3:
        vol = vol[..., None]
    if vol.shape[-1] != codec.mcfg.in_channels:
        raise VqvdbError(f"dense has {vol.shape[-1]} channels, model wants "
                         f"{codec.mcfg.in_channels}")
    ld = LEAF_DIM
    pads = [(-d) % ld for d in vol.shape[:3]]
    # x is padded further, so that every device owns an equal slab.
    nx_local = -(-(vol.shape[0] + pads[0]) // ld // len(devices))
    pads[0] = nx_local * len(devices) * ld - vol.shape[0]
    if any(pads):
        vol = torch.nn.functional.pad(vol, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]),
                                      value=float(background))
    bdims = tuple(d // ld for d in vol.shape[:3])
    slab_x = nx_local * ld
    rows = [_to_blocks(vol[k * slab_x:(k + 1) * slab_x].to(d))
            for k, d in enumerate(devices)]
    active = np.concatenate([((r - background).abs().amax(dim=1) > tolerance).cpu().numpy()
                             for r in rows])
    (flat,) = np.nonzero(active)
    bi = np.stack(np.unravel_index(flat, bdims), axis=1)
    origins = (bi.astype(np.int32) * ld + np.asarray(origin, np.int32)).astype(np.int32)
    n = flat.shape[0]
    index_dtype = np.dtype(codec.mcfg.index_dtype)
    if n == 0:
        return np.zeros((0,) + codec.mcfg.index_shape, index_dtype), origins
    bs = codec.ccfg.batch_size
    c = codec.mcfg.in_channels
    n_local = rows[0].shape[0]
    owner = flat // n_local
    per_slab = []  # every slab's steps are enqueued before any result comes back
    for k, d in enumerate(devices):
        ids = torch.from_numpy((flat[owner == k] - k * n_local).astype(np.int64)).to(d)
        out = []
        for s in range(0, ids.shape[0], bs):
            batch = rows[k].index_select(0, ids[s: s + bs])
            if batch.shape[0] < bs:  # zero rows, as compress pads its last batch
                batch = torch.cat([batch, batch.new_zeros((bs - batch.shape[0],
                                                           batch.shape[1]))])
            out.append(codec._encode_step(batch.view(bs, ld, ld, ld, c)))
        if out:
            per_slab.append(torch.cat(out)[:ids.shape[0]])
    idx = np.concatenate([t.cpu().numpy() for t in per_slab])
    return idx.astype(index_dtype), origins


def decode_file_to_dense(codec, in_path: PathLike, *, background: float = 0.0
                         ) -> List[dict]:
    """Decode every grid of a `.vqvdb` file (v3 to v6) into a dense volume
    on the codec's device: [{name, dense, lo, transform}]. The host reads
    the indices, origins and any v6 stream of a grid, then the grid is
    decoded and corrected on the device (`decode_to_dense`)."""
    bs = codec.ccfg.batch_size
    out: List[dict] = []
    with VqvdbReader(in_path) as r:
        if r.num_embeddings != codec.mcfg.num_embeddings:
            raise ModelMismatchError(f"file has {r.num_embeddings} embeddings, model has "
                                     f"{codec.mcfg.num_embeddings}")
        while r.has_next_grid():
            meta = r.next_grid_metadata()
            if tuple(meta.latent_shape) != codec.mcfg.index_shape:
                raise ModelMismatchError(f"file latent shape {meta.latent_shape} != model "
                                         f"{codec.mcfg.index_shape}")
            if meta.residual_mode and meta.residual_channels != codec.mcfg.in_channels:
                raise ModelMismatchError(
                    f"file residual stream has {meta.residual_channels} channels, "
                    f"model decodes {codec.mcfg.in_channels}")
            parts = [[], [], [], []]
            while r.has_next():
                for part, arr in zip(parts, r.next_batch_residual(bs)):
                    if arr is not None:
                        part.append(arr)
            idx_parts, org_parts, sc_parts, res_parts = parts
            indices = (np.concatenate(idx_parts) if idx_parts else
                       np.zeros((0,) + codec.mcfg.index_shape, codec.mcfg.index_dtype))
            origins = np.concatenate(org_parts) if org_parts else np.zeros((0, 3), np.int32)
            dense, lo = decode_to_dense(
                codec, indices, origins, background=background,
                scales=np.concatenate(sc_parts) if sc_parts else None,
                residual=np.concatenate(res_parts) if res_parts else None)
            out.append({"name": meta.name, "dense": dense, "lo": lo,
                        "transform": meta.transform})
    return out


def encode_dense_to_file(
    codec,
    dense: Union[np.ndarray, torch.Tensor],
    out_path: PathLike,
    *,
    name: str = "density",
    origin: Sequence[int] = (0, 0, 0),
    background: float = 0.0,
    tolerance: float = 0.0,
    transform: Optional[np.ndarray] = None,
    format_version: Optional[int] = None,
    compression: str = "zlib",
) -> dict:
    """Sparsify and encode a dense volume straight to a `.vqvdb` file: the
    file `compress` writes for `LeafGrid.from_dense` of the same volume.
    Only the activity mask and the indices cross to the host."""
    indices, origins = encode_from_dense(codec, dense, origin=origin,
                                         background=background, tolerance=tolerance)
    version = codec._resolve_format(format_version, None, None)
    meta = GridMetadata(
        name=name, num_embeddings=codec.mcfg.num_embeddings,
        latent_shape=codec.mcfg.index_shape, total_blocks=int(indices.shape[0]),
        transform=(np.eye(4, dtype=np.float32) if transform is None
                   else np.asarray(transform, np.float32)))
    bs = codec.ccfg.batch_size
    with VqvdbWriter(out_path, version=version, compression=compression) as w:
        w.start_grid(meta)
        for s in range(0, indices.shape[0], bs):
            w.write_batch(indices[s: s + bs], origins[s: s + bs])
        w.end_grid()
    return {"leaves": int(indices.shape[0]), "bytes": Path(out_path).stat().st_size}
