"""High-level user API (counterpart of `vqvdb_tpu/api.py`): the encoder and
decoder surfaces as Python calls.

    encode(grids, model, out_path, ...)         -> stats
    decode(vqvdb_path, model, ...)              -> (grids, stats)
    encode_sequence / decode_sequence           one `.vqvdb` per frame
    decode_dense(vqvdb_path, model)             -> dense volumes on the device
    encode_dense(dense, model, out_path, ...)   -> stats

`model` is a `.vqmodel` path, a (params, ModelConfig) pair as `load_model`
returns it, or a ready `VQCodec`. Codecs run on `cuda` unless `device="cpu"`
is given; `make_codec(data_parallel=True)` shards every device step over all
local cards (`parallel/mesh.py`), with files byte-identical to one card's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from vqvdb_tpu_torch.core.artifact import load_model  # noqa: F401
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import DeviceLike
from vqvdb_tpu_torch.parallel.mesh import Mesh, make_mesh
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.vdb.grid import LeafGrid

PathLike = Union[str, Path]
ModelLike = Union[PathLike, Tuple[Dict, ModelConfig], VQCodec]


def make_codec(
    model: Union[PathLike, Tuple[Dict, ModelConfig]],
    *,
    batch_size: int = 4096,
    compute_dtype: str = "bfloat16",
    device: DeviceLike = None,
    data_parallel: bool = False,
    mesh: Optional[Mesh] = None,
) -> VQCodec:
    """A codec from a `.vqmodel` path or (params, cfg), on `device`
    (default `cuda`). data_parallel=True shards every device step over a
    mesh of all local devices (`make_mesh(device=device)`: every card, or
    one CPU entry); pass `mesh` instead for another mesh."""
    if isinstance(model, (str, Path)):
        params, mcfg = load_model(model)
    else:
        params, mcfg = model
    if data_parallel and mesh is None:
        mesh = make_mesh(device=device)
    ccfg = CodecConfig(batch_size=batch_size, compute_dtype=compute_dtype)
    return VQCodec(params, mcfg, ccfg, device=device, mesh=mesh)


def _codec(model: ModelLike, batch_size: int, device: DeviceLike) -> VQCodec:
    if isinstance(model, VQCodec):
        return model
    return make_codec(model, batch_size=batch_size, device=device)


def encode(
    grids: Union[LeafGrid, Sequence[LeafGrid]],
    model: ModelLike,
    out_path: PathLike,
    *,
    batch_size: int = 4096,
    device: DeviceLike = None,
    name_filter: Optional[str] = None,
    progress: bool = False,
    format_version: Optional[int] = None,
    compression: str = "zlib",
    residual: Optional[str] = None,
    residual_tol: Optional[float] = None,
    should_stop=None,
) -> dict:
    """Compress grids to a `.vqvdb` file (`VQCodec.compress`): v3, or v4
    for K > 256, by default; v5 with `compression`; v6 with `residual`
    ("int8" | "f16", `residual_tol` for int8). `name_filter` keeps one grid
    by name; `should_stop` is checked between batches (a graceful abort that
    keeps what was written)."""
    codec = _codec(model, batch_size, device)
    if isinstance(grids, LeafGrid):
        grids = [grids]
    if name_filter:
        grids = [g for g in grids if g.name == name_filter]
        if not grids:
            raise ValueError(f"no grid named {name_filter!r}")
    return codec.compress(list(grids), out_path, progress=progress,
                          format_version=format_version, compression=compression,
                          residual=residual, residual_tol=residual_tol,
                          should_stop=should_stop)


def decode(
    in_path: PathLike,
    model: ModelLike,
    *,
    batch_size: int = 4096,
    device: DeviceLike = None,
    progress: bool = False,
    grids=None,
    bbox=None,
) -> Tuple[List[LeafGrid], dict]:
    """Decompress a `.vqvdb` file into LeafGrids (`VQCodec.decompress`);
    `grids` (a name or names) and `bbox` ((lo, hi) voxel corners, hi
    exclusive) select a subset."""
    codec = _codec(model, batch_size, device)
    return codec.decompress(in_path, progress=progress, grids=grids, bbox=bbox)


def encode_sequence(
    frames: Sequence[Union[LeafGrid, Sequence[LeafGrid]]],
    model: ModelLike,
    out_dir: PathLike,
    *,
    pattern: str = "frame_{:04d}.vqvdb",
    batch_size: int = 4096,
    device: DeviceLike = None,
    format_version: Optional[int] = None,
    compression: str = "zlib",
    residual: Optional[str] = None,
) -> dict:
    """Encode an animated sequence, one `.vqvdb` per frame, with one codec
    (its weights and the kernels' prepared operands made once)."""
    codec = _codec(model, batch_size, device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    per_frame = []
    total_leaves = 0
    for i, frame in enumerate(frames):
        stats = codec.compress(frame, out_dir / pattern.format(i),
                               format_version=format_version, compression=compression,
                               residual=residual)
        per_frame.append(stats["seconds"])
        total_leaves += stats["leaves"]
    return {"frames": len(per_frame), "leaves": total_leaves,
            "seconds_per_frame": per_frame,
            "mean_frame_seconds": sum(per_frame) / max(len(per_frame), 1)}


def decode_sequence(
    in_dir: PathLike,
    model: ModelLike,
    *,
    pattern: str = "frame_*.vqvdb",
    batch_size: int = 4096,
    device: DeviceLike = None,
) -> Tuple[List[List[LeafGrid]], dict]:
    """Decode a directory of per-frame `.vqvdb` files, in name order."""
    codec = _codec(model, batch_size, device)
    frames, per_frame = [], []
    for f in sorted(Path(in_dir).glob(pattern)):
        grids, stats = codec.decompress(f)
        frames.append(grids)
        per_frame.append(stats["seconds"])
    return frames, {"frames": len(frames), "seconds_per_frame": per_frame,
                    "mean_frame_seconds": sum(per_frame) / max(len(per_frame), 1)}


def decode_dense(
    in_path: PathLike,
    model: ModelLike,
    *,
    batch_size: int = 4096,
    device: DeviceLike = None,
    background: float = 0.0,
) -> List[dict]:
    """Decode a `.vqvdb` file into dense volumes that stay on the codec's
    device: [{name, dense (tensor [X,Y,Z,C]), lo, transform}]
    (`runtime/dense.py`)."""
    from vqvdb_tpu_torch.runtime.dense import decode_file_to_dense

    return decode_file_to_dense(_codec(model, batch_size, device), in_path,
                                background=background)


def encode_dense(
    dense,
    model: ModelLike,
    out_path: PathLike,
    *,
    name: str = "density",
    batch_size: int = 4096,
    device: DeviceLike = None,
    origin: Sequence[int] = (0, 0, 0),
    background: float = 0.0,
    tolerance: float = 0.0,
    format_version: Optional[int] = None,
    compression: str = "zlib",
) -> dict:
    """Sparsify and encode a dense volume (numpy, or a tensor on the codec's
    device) straight to a `.vqvdb` file; the volume stays on the device."""
    from vqvdb_tpu_torch.runtime.dense import encode_dense_to_file

    return encode_dense_to_file(
        _codec(model, batch_size, device), dense, out_path, name=name, origin=origin,
        background=background, tolerance=tolerance, format_version=format_version,
        compression=compression)
