""".vqvdb container, v3 to v6: streaming reader and writer (counterpart of
`vqvdb_tpu/format/vqvdb.py`; byte-identical output, each package reads the
other's files).

Byte layout (little-endian, packed):

  file header (12 B):
      char[5]  magic      = "VQVDB"
      u8       version    = 3, 4, 5 or 6
      u8       numGrids
      u32      numEmbeddings          (shared across all grids)
      u8       latentDimCount         (shared across all grids)

  per grid:
      u32      nameLength
      char[nameLength] name
      f32[16]  transform              (4x4 index->world affine, row-major)
      u16[latentDimCount] latentShape (e.g. 4,4,4)
      u32      totalBlocks
      v5, v6:  u8 codec (0 zlib, 1 lzma, 2 lz4 block format)
      v6:      u8 residualMode (0 none, 1 int8 per-leaf scaled, 2 f16),
               u8 residualChannels (C; 0 when the mode is 0)
      v3, v4:  totalBlocks x chunk:
                  i32[3]  leaf origin (12 B)
                  indices: u8[prod(latentShape)] in v3; in v4 u8 when
                  numEmbeddings <= 256, else little-endian u16
      v5, v6:  frames of [u32 nChunks, u64 compBytes, blob]; a blob
               decompresses to the origins as deltas (i32[n,3], first row
               absolute), the indices block (v4's widths), and in v6 with
               mode 1 a f32[n] scale block + i8[n, 512*C] residual block,
               with mode 2 a f16[n, 512*C] residual block.

The writer emits a placeholder header and patches numGrids and the shared
fields on close. The v6 residual is the reconstruction error of each leaf
against the codec's own decode (`runtime/residual.py`); a reader may drop it
and still has a valid lossy decode.
"""

from __future__ import annotations

import dataclasses
import io
import lzma
import struct
import zlib
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from vqvdb_tpu_torch.utils.errors import FormatError, VersionError

MAGIC = b"VQVDB"
FORMAT_VERSION = 3
FORMAT_VERSION_V4 = 4  # u16 indices for codebooks beyond 256 codes
FORMAT_VERSION_V5 = 5  # v4 widths in compressed frames
FORMAT_VERSION_V6 = 6  # v5 plus a per-grid residual-correction stream
SUPPORTED_VERSIONS = (FORMAT_VERSION, FORMAT_VERSION_V4, FORMAT_VERSION_V5,
                      FORMAT_VERSION_V6)

V5_CODECS = {"zlib": 0, "lzma": 1, "lz4": 2}
RESIDUAL_MODES = {"none": 0, "int8": 1, "f16": 2}
RESIDUAL_MODE_NAMES = {v: k for k, v in RESIDUAL_MODES.items()}

_HEADER_STRUCT = struct.Struct("<5sBBIB")
HEADER_SIZE = _HEADER_STRUCT.size  # 12
ORIGIN_BYTES = 12  # 3 x i32
LEAF_VOXELS = 512  # values per channel of a leaf in the v6 residual stream


def _v5_compress(codec_id: int, raw: bytes) -> bytes:
    if codec_id == 0:
        return zlib.compress(raw, 9)
    if codec_id == 1:
        return lzma.compress(raw, preset=6)
    from vqvdb_tpu_torch.runtime import native_io

    return native_io.lz4_compress(raw)


def _v5_decompress(codec_id: int, blob: bytes, raw_size: int) -> bytes:
    """One frame blob -> exactly raw_size bytes (an LZ4 block carries no
    size of its own). Malformed payloads raise FormatError."""
    try:
        if codec_id == 0:
            return zlib.decompress(blob)
        if codec_id == 1:
            return lzma.decompress(blob)
        from vqvdb_tpu_torch.runtime import native_io

        return native_io.lz4_decompress(blob, raw_size)
    except FormatError:
        raise
    except (zlib.error, lzma.LZMAError, EOFError, ValueError) as e:
        raise FormatError(f"v5 frame payload failed to decompress: {e}") from e


def _delta_encode_origins(origins: np.ndarray) -> np.ndarray:
    out = np.ascontiguousarray(origins, np.int32).copy()
    out[1:] -= np.asarray(origins[:-1], np.int32)
    return out


def _delta_decode_origins(deltas: np.ndarray) -> np.ndarray:
    return np.cumsum(deltas.astype(np.int64), axis=0).astype(np.int32)


def _framed(version: int) -> bool:
    """True for versions whose payload is compressed frames (v5, v6)."""
    return version >= FORMAT_VERSION_V5


def _index_bytes(version: int, num_embeddings: int) -> int:
    if version == FORMAT_VERSION:
        return 1
    return 1 if num_embeddings <= 256 else 2


def chunk_dtype(num_indices: int, index_bytes: int) -> np.dtype:
    """Packed v3/v4 (origin, indices) chunk as a numpy structured dtype."""
    return np.dtype([("origin", "<i4", (3,)),
                     ("indices", "u1" if index_bytes == 1 else "<u2", (num_indices,))])


@dataclasses.dataclass
class GridMetadata:
    """Per-grid metadata block. index_bytes is 1 for v3 files and for later
    ones with K <= 256, else 2. residual_mode / residual_channels describe
    the v6 residual stream (0 / 0 without one)."""

    name: str
    num_embeddings: int
    latent_shape: Tuple[int, ...]
    total_blocks: int
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    index_bytes: int = 1
    residual_mode: int = 0
    residual_channels: int = 0

    def __post_init__(self) -> None:
        self.latent_shape = tuple(int(d) for d in self.latent_shape)
        self.transform = np.asarray(self.transform, dtype=np.float32).reshape(4, 4)
        if self.residual_mode not in RESIDUAL_MODE_NAMES:
            raise FormatError(f"unknown residual mode {self.residual_mode}")
        if self.residual_mode and self.residual_channels < 1:
            raise FormatError("residual grids must declare residual_channels >= 1")

    @property
    def num_indices(self) -> int:
        return int(np.prod(self.latent_shape))

    @property
    def index_dtype(self):
        return np.uint8 if self.index_bytes == 1 else np.uint16

    @property
    def block_data_size(self) -> int:
        """Index payload bytes per leaf."""
        return self.num_indices * self.index_bytes

    @property
    def residual_dtype(self):
        return {1: np.int8, 2: np.float16}.get(self.residual_mode)

    @property
    def residual_values(self) -> int:
        """Residual values per leaf (voxels x channels); 0 without residuals."""
        if self.residual_mode == 0:
            return 0
        return LEAF_VOXELS * self.residual_channels

    @property
    def residual_bytes(self) -> int:
        """Residual payload bytes per leaf (with the int8 mode's f32 scale)."""
        if self.residual_mode == 0:
            return 0
        scale = 4 if self.residual_mode == 1 else 0
        return scale + self.residual_values * np.dtype(self.residual_dtype).itemsize

    @property
    def chunk_size(self) -> int:
        return ORIGIN_BYTES + self.block_data_size + self.residual_bytes


class VqvdbWriter:
    """Streaming writer with deferred header finalization.

        with VqvdbWriter(path, version=5, compression="lz4") as w:
            w.start_grid(meta)
            w.write_batch(indices, origins)   # repeatedly
            w.end_grid()
    """

    def __init__(self, path: Union[str, Path], *, version: int = FORMAT_VERSION,
                 compression: str = "zlib"):
        if version not in SUPPORTED_VERSIONS:
            raise VersionError(f"unsupported vqvdb version {version}")
        if compression not in V5_CODECS:
            raise VersionError(f"unknown v5 compression codec {compression!r}")
        self.version = version
        self._codec_id = V5_CODECS[compression]
        self._f: Optional[io.BufferedWriter] = open(path, "wb")
        self._num_grids = 0
        self._shared_num_embeddings = 0
        self._shared_latent_dim_count = 0
        self._index_bytes = 1
        self._num_indices = 0
        self._blocks_written_in_grid = 0
        self._declared_blocks = 0
        self._grid_open = False
        self._total_blocks_pos = 0
        self._residual_mode = 0
        self._residual_values = 0
        self._f.write(_HEADER_STRUCT.pack(MAGIC, version, 0, 0, 0))

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
        if self.version == FORMAT_VERSION and metadata.num_embeddings > 256:
            raise FormatError(
                "v3 stores 1 byte per index; num_embeddings > 256 requires "
                "version=4")
        if metadata.residual_mode and self.version != FORMAT_VERSION_V6:
            raise FormatError("residual-correction streams require format version 6")
        self._index_bytes = _index_bytes(self.version, metadata.num_embeddings)
        self._num_indices = metadata.num_indices
        self._declared_blocks = int(metadata.total_blocks)
        self._blocks_written_in_grid = 0
        self._grid_open = True
        self._residual_mode = int(metadata.residual_mode)
        self._residual_values = metadata.residual_values

        name_bytes = metadata.name.encode("utf-8")
        f.write(struct.pack("<I", len(name_bytes)))
        f.write(name_bytes)
        f.write(metadata.transform.astype(np.float32).tobytes())  # 64 B
        f.write(np.asarray(metadata.latent_shape, dtype=np.uint16).tobytes())
        self._total_blocks_pos = f.tell()  # patched by abort_grid()
        f.write(struct.pack("<I", int(metadata.total_blocks)))
        if _framed(self.version):
            f.write(struct.pack("<B", self._codec_id))
        if self.version == FORMAT_VERSION_V6:
            f.write(struct.pack("<BB", self._residual_mode,
                                int(metadata.residual_channels)))
        self._num_grids += 1

    def write_batch(self, indices: np.ndarray, origins: np.ndarray,
                    scales: Optional[np.ndarray] = None,
                    residual: Optional[np.ndarray] = None) -> None:
        """Append a batch of (origin, indices[, residual]) chunks:
        interleaved for v3/v4, one compressed frame for v5/v6.

        indices:  [B, *latent_shape] (or [B, num_indices]), stored as u8 or
                  u16 by the grid's index width
        origins:  int32 [B, 3] leaf origins in index space
        scales:   f32 [B] per-leaf residual scales (v6 int8 mode only)
        residual: i8/f16 [B, 512*C] (any [B, ...] of that size; v6 residual
                  grids only)
        """
        f = self._require_open()
        n = indices.shape[0]
        if n == 0:
            return
        dtype = np.uint8 if self._index_bytes == 1 else np.uint16
        indices = np.ascontiguousarray(indices, dtype=dtype).reshape(n, -1)
        if self._residual_mode == 0 and (scales is not None or residual is not None):
            raise FormatError("residual data passed to a grid declared without residuals")
        if _framed(self.version):
            raw = _delta_encode_origins(origins).tobytes() + indices.tobytes()
            if self._residual_mode:
                rdtype = np.int8 if self._residual_mode == 1 else np.float16
                if residual is None:
                    raise FormatError("residual grid batch without residual")
                residual = np.ascontiguousarray(residual, rdtype).reshape(n, -1)
                if residual.shape[1] != self._residual_values:
                    raise FormatError(
                        f"residual rows carry {residual.shape[1]} values, "
                        f"grid declares {self._residual_values}")
                if self._residual_mode == 1:
                    if scales is None:
                        raise FormatError("int8 residual batch without scales")
                    scales = np.ascontiguousarray(scales, np.float32).reshape(-1)
                    if scales.shape[0] != n:
                        raise FormatError(f"{scales.shape[0]} scales vs {n} chunks")
                    raw += scales.tobytes()
                raw += residual.tobytes()
            blob = _v5_compress(self._codec_id, raw)
            f.write(struct.pack("<IQ", n, len(blob)))
            f.write(blob)
            self._blocks_written_in_grid += n
            return
        origins = np.ascontiguousarray(origins, dtype=np.int32).reshape(-1, 3)
        if origins.shape[0] != n:
            raise FormatError(
                f"batch mismatch: {n} index rows vs {origins.shape[0]} origins")
        if indices.shape[1] != self._num_indices:
            raise FormatError(
                f"indices row size {indices.shape[1]} != latent size "
                f"{self._num_indices}")
        chunks = np.empty(n, chunk_dtype(self._num_indices, self._index_bytes))
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
                    MAGIC, self.version, self._num_grids,
                    self._shared_num_embeddings, self._shared_latent_dim_count))
        finally:
            f.close()
            self._f = None

    def _require_open(self) -> io.BufferedWriter:
        if self._f is None:
            raise RuntimeError("writer is closed")
        return self._f


class VqvdbReader:
    """Streaming reader: has_next_grid / next_grid_metadata / has_next /
    next_batch (next_batch_residual with the v6 stream)."""

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
            if version not in SUPPORTED_VERSIONS:
                raise VersionError(
                    f"Unsupported VQVDB version. Expected {FORMAT_VERSION}, "
                    f"got {version}")
            if version == FORMAT_VERSION and num_embeddings > 256:
                raise FormatError(
                    "v3 stores 1 byte per index; header declares "
                    f"num_embeddings={int(num_embeddings)} > 256 "
                    "(corrupt or mis-versioned file)")
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
        self._grid_codec_id = 0
        # v5/v6 frame buffer: decompressed chunks not yet handed out.
        self._buf: Optional[list] = None

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
        latent_shape: Tuple[int, ...] = ()
        if self.latent_dim_count > 0:
            latent_shape = tuple(int(v) for v in np.frombuffer(
                self._read_exact(2 * self.latent_dim_count, "latent shape"),
                dtype=np.uint16))
        (total_blocks,) = struct.unpack("<I", self._read_exact(4, "total block count"))
        residual_mode = residual_channels = 0
        if _framed(self.version):
            (self._grid_codec_id,) = struct.unpack("<B", self._read_exact(1, "v5 codec id"))
            if self._grid_codec_id not in V5_CODECS.values():
                raise FormatError(f"unknown v5 payload codec {self._grid_codec_id}")
            if self.version == FORMAT_VERSION_V6:
                residual_mode, residual_channels = struct.unpack(
                    "<BB", self._read_exact(2, "v6 residual descriptor"))
                if residual_mode not in RESIDUAL_MODE_NAMES:
                    raise FormatError(f"unknown v6 residual mode {residual_mode}")
            self._buf = None
        self._meta = GridMetadata(
            name=name,
            num_embeddings=self.num_embeddings,
            latent_shape=latent_shape,
            total_blocks=int(total_blocks),
            transform=transform,
            index_bytes=_index_bytes(self.version, self.num_embeddings),
            residual_mode=residual_mode,
            residual_channels=residual_channels,
        )
        self._blocks_read = 0
        self._current_grid += 1
        return self._meta

    @property
    def grid_codec(self) -> Optional[str]:
        """Payload codec name of the current grid (v5/v6 only; None otherwise)."""
        if not _framed(self.version):
            return None
        return {cid: name for name, cid in V5_CODECS.items()}.get(self._grid_codec_id)

    def has_next(self) -> bool:
        return self._meta is not None and self._blocks_read < self._meta.total_blocks

    def next_batch(self, max_batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Read up to max_batch chunks: (indices [B, *latent_shape] in the
        grid's index dtype, origins i32 [B, 3]). A v6 residual stream is read
        and dropped (a valid lossy decode)."""
        indices, origins, _, _ = self.next_batch_residual(max_batch)
        return indices, origins

    def next_batch_residual(
        self, max_batch: int
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        """Read up to max_batch chunks with their residual correction data:
        (indices, origins, scales f32 [B] in the int8 mode else None,
        residual i8/f16 [B, 512*C] or None without residuals)."""
        meta = self._meta
        if not self.has_next():
            mode = meta.residual_mode if meta else 0
            return (
                np.empty((0,) + (meta.latent_shape if meta else ()),
                         meta.index_dtype if meta else np.uint8),
                np.empty((0, 3), np.int32),
                np.empty((0,), np.float32) if mode == 1 else None,
                np.empty((0, meta.residual_values), meta.residual_dtype) if mode else None,
            )
        want = min(int(max_batch), meta.total_blocks - self._blocks_read)
        if _framed(self.version):
            return self._next_batch_framed(want)
        raw = self._f.read(want * meta.chunk_size)
        if len(raw) < want * meta.chunk_size:
            raise FormatError("File truncated: Incomplete read during refill.")
        chunks = np.frombuffer(raw, chunk_dtype(meta.num_indices, meta.index_bytes))
        indices = chunks["indices"].reshape((want,) + meta.latent_shape).copy()
        origins = chunks["origin"].copy()
        self._blocks_read += want
        return indices, origins, None, None

    def _next_batch_framed(self, want: int):
        """Serve up to `want` chunks from the frame buffer, refilling by
        decompressing whole frames (memory stays bounded by the writer's
        batch size)."""
        meta = self._meta
        mode = meta.residual_mode
        while self._buf is None or self._buf[0].shape[0] == 0:
            n, comp = struct.unpack("<IQ", self._read_exact(12, "v5 frame header"))
            # The buffer is empty here, so every block not yet handed out
            # must still be on disk.
            if n == 0 or n > meta.total_blocks - self._blocks_read:
                raise FormatError("v5 frame chunk count out of range.")
            raw_size = n * meta.chunk_size
            raw = _v5_decompress(self._grid_codec_id,
                                 self._read_exact(comp, "v5 frame payload"), raw_size)
            if len(raw) != raw_size:
                raise FormatError("v5 frame decompressed to the wrong size.")
            origins = _delta_decode_origins(
                np.frombuffer(raw, np.int32, count=3 * n).reshape(n, 3))
            off = n * ORIGIN_BYTES
            indices = np.frombuffer(raw, meta.index_dtype, offset=off,
                                    count=n * meta.num_indices
                                    ).reshape((n,) + meta.latent_shape)
            off += n * meta.block_data_size
            scales = residual = None
            if mode == 1:
                scales = np.frombuffer(raw, np.float32, offset=off, count=n)
                off += 4 * n
            if mode:
                residual = np.frombuffer(raw, meta.residual_dtype, offset=off,
                                         count=n * meta.residual_values
                                         ).reshape(n, meta.residual_values)
            self._buf = [indices, origins, scales, residual]
        take = min(want, self._buf[0].shape[0])
        out = tuple(None if a is None else np.ascontiguousarray(a[:take])
                    for a in self._buf)
        self._buf = [None if a is None else a[take:] for a in self._buf]
        self._blocks_read += take
        return out

    def skip_grid_payload(self) -> int:
        """Skip the rest of the current grid's payload without decoding.
        Returns the on-disk payload bytes skipped (raw chunks for v3/v4,
        frame headers and compressed blobs for v5/v6). The reader is left at
        the next grid's metadata; a truncated file still raises."""
        meta = self._meta
        if meta is None:
            raise FormatError("No grid is open.")
        f = self._f
        pos = f.tell()
        size = f.seek(0, 2)
        f.seek(pos, 0)
        skipped = 0
        if _framed(self.version):
            # Chunks already decompressed into the buffer were counted on
            # disk in their frame; drop them and walk the remaining frames.
            self._blocks_read += 0 if self._buf is None else self._buf[0].shape[0]
            self._buf = None
            while self._blocks_read < meta.total_blocks:
                n, comp = struct.unpack("<IQ", self._read_exact(12, "v5 frame header"))
                if n == 0 or n > meta.total_blocks - self._blocks_read:
                    raise FormatError("v5 frame chunk count out of range.")
                if f.seek(comp, 1) > size:
                    raise FormatError("File truncated: v5 frame payload past end of file.")
                skipped += 12 + comp
                self._blocks_read += n
            return skipped
        skipped = (meta.total_blocks - self._blocks_read) * meta.chunk_size
        if f.seek(skipped, 1) > size:
            raise FormatError("File truncated: grid payload past end of file.")
        self._blocks_read = meta.total_blocks
        return skipped

    def iter_grids(self, batch_size: int = 4096
                   ) -> Iterator[Tuple[GridMetadata, Iterator[Tuple[np.ndarray, np.ndarray]]]]:
        while self.has_next_grid():
            meta = self.next_grid_metadata()

            def batches() -> Iterator[Tuple[np.ndarray, np.ndarray]]:
                while self.has_next():
                    yield self.next_batch(batch_size)

            yield meta, batches()

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


def write_single_grid(
    path: Union[str, Path],
    name: str,
    indices: np.ndarray,
    origins: np.ndarray,
    num_embeddings: int,
    transform: Optional[np.ndarray] = None,
) -> None:
    """One-shot write of a single grid to a v3 file (the JAX package's
    convenience for tests and the CLI; K > 256 raises FormatError, as v3
    holds one byte per index)."""
    meta = GridMetadata(
        name=name,
        num_embeddings=num_embeddings,
        latent_shape=tuple(indices.shape[1:]),
        total_blocks=indices.shape[0],
        transform=np.eye(4, dtype=np.float32) if transform is None else transform,
    )
    with VqvdbWriter(path) as w:
        w.start_grid(meta)
        w.write_batch(indices, origins)
        w.end_grid()
