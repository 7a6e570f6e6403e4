""".vqvdb v3 container: streaming reader and writer (counterpart of
`vqvdb_tpu/format/vqvdb.py`, v3 only; byte-identical output).

Byte layout (little-endian, packed):

  file header (12 B):
      char[5]  magic      = "VQVDB"
      u8       version    = 3
      u8       numGrids
      u32      numEmbeddings          (shared across all grids)
      u8       latentDimCount         (shared across all grids)

  per grid:
      u32      nameLength
      char[nameLength] name
      f32[16]  transform              (4x4 index->world affine, row-major)
      u16[latentDimCount] latentShape (e.g. 4,4,4)
      u32      totalBlocks
      totalBlocks x chunk:
          i32[3]  leaf origin (12 B)
          u8[prod(latentShape)] codebook indices (64 B for 4x4x4)

The writer emits a placeholder header and patches numGrids and the shared
fields on close. Any version other than 3 raises VersionError; the later
tiers (v4 u16 indices, v5 compressed frames, v6 residuals) are not ported.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from vqvdb_tpu_torch.utils.errors import FormatError, VersionError

MAGIC = b"VQVDB"
FORMAT_VERSION = 3
_HEADER_STRUCT = struct.Struct("<5sBBIB")
HEADER_SIZE = _HEADER_STRUCT.size  # 12
ORIGIN_BYTES = 12  # 3 x i32


def chunk_dtype(block_bytes: int) -> np.dtype:
    """Packed (origin, indices) chunk as a numpy structured dtype."""
    return np.dtype([("origin", "<i4", (3,)), ("indices", "u1", (block_bytes,))])


@dataclasses.dataclass
class GridMetadata:
    """Per-grid metadata block."""

    name: str
    num_embeddings: int
    latent_shape: Tuple[int, ...]
    total_blocks: int
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )

    def __post_init__(self) -> None:
        self.latent_shape = tuple(int(d) for d in self.latent_shape)
        self.transform = np.asarray(self.transform, dtype=np.float32).reshape(4, 4)

    @property
    def num_indices(self) -> int:
        return int(np.prod(self.latent_shape))

    @property
    def chunk_size(self) -> int:
        return ORIGIN_BYTES + self.num_indices


class VqvdbWriter:
    """Streaming v3 writer with deferred header finalization.

        with VqvdbWriter(path) as w:
            w.start_grid(meta)
            w.write_batch(indices_u8, origins_i32)   # repeatedly
            w.end_grid()
    """

    def __init__(self, path: Union[str, Path], *, version: int = FORMAT_VERSION):
        if version != FORMAT_VERSION:
            raise VersionError(f"unsupported vqvdb version {version} "
                               f"(this package writes v{FORMAT_VERSION} only)")
        self._f: Optional[io.BufferedWriter] = open(path, "wb")
        self._num_grids = 0
        self._shared_num_embeddings = 0
        self._shared_latent_dim_count = 0
        self._num_indices = 0
        self._blocks_written_in_grid = 0
        self._declared_blocks = 0
        self._grid_open = False
        self._total_blocks_pos = 0
        self._f.write(_HEADER_STRUCT.pack(MAGIC, FORMAT_VERSION, 0, 0, 0))

    def __enter__(self) -> "VqvdbWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            # Keep the in-flight exception; just release the file handle.
            self._grid_open = False
        self.close()

    def start_grid(self, metadata: GridMetadata) -> None:
        f = self._require_open()
        if self._num_grids == 0:
            self._shared_num_embeddings = int(metadata.num_embeddings)
            self._shared_latent_dim_count = len(metadata.latent_shape)
        else:
            if metadata.num_embeddings != self._shared_num_embeddings:
                raise FormatError("Inconsistent number of embeddings across grids.")
            if len(metadata.latent_shape) != self._shared_latent_dim_count:
                raise FormatError("Inconsistent latent dimension count across grids.")
        if self._num_grids >= 255:
            raise FormatError("v3 format stores numGrids as u8 (max 255 grids).")
        if metadata.num_embeddings > 256:
            raise FormatError(
                "v3 stores 1 byte per index; num_embeddings > 256 requires "
                "version=4")
        self._num_indices = metadata.num_indices
        self._declared_blocks = int(metadata.total_blocks)
        self._blocks_written_in_grid = 0
        self._grid_open = True

        name_bytes = metadata.name.encode("utf-8")
        f.write(struct.pack("<I", len(name_bytes)))
        f.write(name_bytes)
        f.write(metadata.transform.astype(np.float32).tobytes())  # 64 B
        f.write(np.asarray(metadata.latent_shape, dtype=np.uint16).tobytes())
        self._total_blocks_pos = f.tell()  # patched by abort_grid()
        f.write(struct.pack("<I", int(metadata.total_blocks)))
        self._num_grids += 1

    def write_batch(self, indices: np.ndarray, origins: np.ndarray) -> None:
        """Append interleaved (origin, indices) chunks.

        indices: uint8 [B, *latent_shape] (or [B, num_indices])
        origins: int32 [B, 3] leaf origins in index space
        """
        f = self._require_open()
        n = indices.shape[0]
        if n == 0:
            return
        indices = np.ascontiguousarray(indices, dtype=np.uint8).reshape(n, -1)
        origins = np.ascontiguousarray(origins, dtype=np.int32).reshape(-1, 3)
        if origins.shape[0] != n:
            raise FormatError(
                f"batch mismatch: {n} index rows vs {origins.shape[0]} origins")
        if indices.shape[1] != self._num_indices:
            raise FormatError(
                f"indices row size {indices.shape[1]} != latent size "
                f"{self._num_indices}")
        chunks = np.empty(n, chunk_dtype(self._num_indices))
        chunks["origin"] = origins
        chunks["indices"] = indices
        f.write(chunks.tobytes())
        self._blocks_written_in_grid += n

    def end_grid(self) -> None:
        if self._blocks_written_in_grid != self._declared_blocks:
            raise FormatError(
                f"grid declared {self._declared_blocks} blocks but "
                f"{self._blocks_written_in_grid} were written")
        self._grid_open = False

    def abort_grid(self) -> None:
        """Finalize the open grid at the blocks actually written: its
        declared count is patched in place, so the file stays valid. A no-op
        when no grid is open."""
        if self._f is None or not self._grid_open:
            return
        f = self._f
        if self._blocks_written_in_grid != self._declared_blocks:
            pos = f.tell()
            f.seek(self._total_blocks_pos)
            f.write(struct.pack("<I", self._blocks_written_in_grid))
            f.seek(pos)
        self._grid_open = False

    def close(self) -> None:
        if self._f is None:
            return
        f = self._f
        try:
            if self._grid_open:
                self.end_grid()
            if self._num_grids > 0:
                f.seek(0)
                f.write(_HEADER_STRUCT.pack(
                    MAGIC, FORMAT_VERSION, self._num_grids,
                    self._shared_num_embeddings, self._shared_latent_dim_count))
        finally:
            f.close()
            self._f = None

    def _require_open(self) -> io.BufferedWriter:
        if self._f is None:
            raise RuntimeError("writer is closed")
        return self._f


class VqvdbReader:
    """Streaming v3 reader: has_next_grid / next_grid_metadata / has_next /
    next_batch."""

    def __init__(self, path: Union[str, Path]):
        self._f = open(path, "rb")
        try:
            raw = self._f.read(HEADER_SIZE)
            if len(raw) < HEADER_SIZE:
                raise FormatError("Failed to read file header.")
            magic, version, num_grids, num_embeddings, latent_dim_count = (
                _HEADER_STRUCT.unpack(raw))
            if magic != MAGIC:
                raise FormatError("Invalid VQVDB magic number.")
            if version != FORMAT_VERSION:
                raise VersionError(
                    f"Unsupported VQVDB version. Expected {FORMAT_VERSION}, "
                    f"got {version}")
            if num_embeddings > 256:
                raise FormatError(
                    "v3 stores 1 byte per index; header declares "
                    f"num_embeddings={int(num_embeddings)} > 256")
        except Exception:
            self.close()
            raise
        self.version = int(version)
        self.num_grids = int(num_grids)
        self.num_embeddings = int(num_embeddings)
        self.latent_dim_count = int(latent_dim_count)
        self._current_grid = 0
        self._meta: Optional[GridMetadata] = None
        self._blocks_read = 0

    def __enter__(self) -> "VqvdbReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def has_next_grid(self) -> bool:
        return self._current_grid < self.num_grids

    def next_grid_metadata(self) -> GridMetadata:
        if not self.has_next_grid():
            raise FormatError("No more grids available.")
        (name_len,) = struct.unpack("<I", self._read_exact(4, "grid name length"))
        name = self._read_exact(name_len, "grid name").decode("utf-8")
        transform = np.frombuffer(
            self._read_exact(64, "header extension"), dtype=np.float32
        ).reshape(4, 4).copy()
        latent_shape = tuple(
            int(v) for v in np.frombuffer(
                self._read_exact(2 * self.latent_dim_count, "latent shape"),
                dtype=np.uint16))
        (total_blocks,) = struct.unpack("<I", self._read_exact(4, "total block count"))
        self._meta = GridMetadata(
            name=name,
            num_embeddings=self.num_embeddings,
            latent_shape=latent_shape,
            total_blocks=int(total_blocks),
            transform=transform,
        )
        self._blocks_read = 0
        self._current_grid += 1
        return self._meta

    def has_next(self) -> bool:
        return self._meta is not None and self._blocks_read < self._meta.total_blocks

    def next_batch(self, max_batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Read up to max_batch chunks: (indices u8 [B, *latent_shape],
        origins i32 [B, 3])."""
        meta = self._meta
        if not self.has_next():
            shape = (0,) + (meta.latent_shape if meta else ())
            return np.empty(shape, np.uint8), np.empty((0, 3), np.int32)
        want = min(int(max_batch), meta.total_blocks - self._blocks_read)
        raw = self._f.read(want * meta.chunk_size)
        if len(raw) < want * meta.chunk_size:
            raise FormatError("File truncated: Incomplete read during refill.")
        chunks = np.frombuffer(raw, chunk_dtype(meta.num_indices))
        indices = chunks["indices"].reshape((want,) + meta.latent_shape).copy()
        origins = chunks["origin"].copy()
        self._blocks_read += want
        return indices, origins

    def read_grid(self) -> Tuple[GridMetadata, np.ndarray, np.ndarray]:
        """Read the next whole grid: (meta, indices [N,*ls], origins [N,3])."""
        meta = self.next_grid_metadata()
        indices, origins = self.next_batch(meta.total_blocks)
        return meta, indices, origins

    def _read_exact(self, n: int, what: str) -> bytes:
        raw = self._f.read(n)
        if len(raw) != n:
            raise FormatError(f"Failed to read {what}.")
        return raw
