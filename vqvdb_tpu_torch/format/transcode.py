"""Container transcoding: rewrite `.vqvdb` files between versions, payload
codecs and fidelity tiers without a model (counterpart of
`vqvdb_tpu/format/transcode.py`).

The index payload is the same in every container version, so v3 <-> v4 <->
v5 <-> v6 is a re-framing: read chunks, write chunks. Uses: a v3 file as
v5-lz4 for fast reads, a v5-zlib archive as v5-lzma for cold storage, the
residual stream stripped from a v6 master for a small lossy proxy (only on
request: silently dropping fidelity is refused), single grids extracted
into their own files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

from vqvdb_tpu_torch.format.vqvdb import (
    GridMetadata,
    VqvdbReader,
    VqvdbWriter,
)
from vqvdb_tpu_torch.utils.errors import FormatError

_BATCH = 4096


def transcode(
    in_path: Union[str, Path],
    out_path: Union[str, Path],
    *,
    version: Optional[int] = None,
    compression: str = "zlib",
    drop_residual: bool = False,
    grids=None,
    batch_size: int = _BATCH,
) -> dict:
    """Rewrite a `.vqvdb` container.

    version: target container version (None = keep the source's).
    compression: v5/v6 payload codec for the target (ignored for v3/v4).
    drop_residual: required to write a residual-carrying source to a
        target without the residual stream (v3/v4/v5 target, or explicit
        downgrade) — the result decodes lossy.
    grids: a name or iterable of names to keep; others are skipped on
        disk without decompression.

    Returns {grids, leaves, bytes_in, bytes_out}.
    """
    in_path, out_path = Path(in_path), Path(out_path)
    names = None
    if grids is not None:
        names = {grids} if isinstance(grids, str) else set(grids)
    total_grids = total_leaves = 0
    with VqvdbReader(in_path) as r:
        out_version = int(version) if version is not None else r.version
        with VqvdbWriter(out_path, version=out_version,
                         compression=compression) as w:
            while r.has_next_grid():
                meta = r.next_grid_metadata()
                if names is not None and meta.name not in names:
                    r.skip_grid_payload()
                    continue
                keep_residual = (bool(meta.residual_mode)
                                 and out_version == 6 and not drop_residual)
                if meta.residual_mode and not keep_residual and not drop_residual:
                    raise FormatError(
                        f"grid '{meta.name}' carries a residual-correction "
                        f"stream; writing it to v{out_version} discards "
                        "fidelity — pass drop_residual=True to confirm")
                out_meta = GridMetadata(
                    name=meta.name,
                    num_embeddings=meta.num_embeddings,
                    latent_shape=meta.latent_shape,
                    total_blocks=meta.total_blocks,
                    transform=meta.transform,
                    residual_mode=meta.residual_mode if keep_residual else 0,
                    residual_channels=(meta.residual_channels
                                       if keep_residual else 0),
                )
                w.start_grid(out_meta)
                while r.has_next():
                    idx, org, sc, res = r.next_batch_residual(batch_size)
                    if keep_residual:
                        w.write_batch(idx, org, sc, res)
                    else:
                        w.write_batch(idx, org)
                    total_leaves += idx.shape[0]
                w.end_grid()
                total_grids += 1
    if total_grids == 0 and names is not None:
        out_path.unlink(missing_ok=True)
        raise FormatError(f"no grids matched {sorted(names)!r}")
    return {
        "grids": total_grids,
        "leaves": total_leaves,
        "bytes_in": in_path.stat().st_size,
        "bytes_out": out_path.stat().st_size,
    }
