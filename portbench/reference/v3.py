"""Frozen v3 `.vqvdb` writer and reader (one or more grids, u8 indices).

Little-endian, packed: a 12-byte header (b"VQVDB", u8 version 3, u8 grid
count, u32 codebook size, u8 latent rank), then per grid a u32 name length
and the name, the 4x4 f32 transform, u16 latent shape, u32 leaf count, and
one 12 + prod(latent shape) byte chunk per leaf: i32[3] origin, u8 indices.
v4 (`v4.py`) shares this layout with another version byte and, for more
than 256 codes, u16 indices; `write_version` and `read_version` hold it for
both.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

HEADER = struct.Struct("<5sBBIB")


def index_bytes(version: int, num_embeddings: int) -> int:
    """Bytes an index takes: 1 in v3, and in v4 for up to 256 codes; else 2."""
    return 1 if version == 3 or num_embeddings <= 256 else 2


def _chunk(num_indices: int, nbytes: int) -> np.dtype:
    return np.dtype([("origin", "<i4", (3,)),
                     ("indices", "u1" if nbytes == 1 else "<u2", (num_indices,))])


def write_version(path: Union[str, Path], version: int, name: str, origins: np.ndarray,
                  indices: np.ndarray, num_embeddings: int) -> None:
    """One grid in the v3 layout with version byte `version`."""
    n, latent = indices.shape[0], indices.shape[1:]
    chunks = np.empty(n, _chunk(int(np.prod(latent)), index_bytes(version, num_embeddings)))
    chunks["origin"] = origins
    chunks["indices"] = indices.reshape(n, -1)
    name_b = name.encode()
    with open(path, "wb") as f:
        f.write(HEADER.pack(b"VQVDB", version, 1, num_embeddings, len(latent)))
        f.write(struct.pack("<I", len(name_b)) + name_b)
        f.write(np.eye(4, dtype="<f4").tobytes())
        f.write(np.asarray(latent, "<u2").tobytes())
        f.write(struct.pack("<I", n))
        f.write(chunks.tobytes())


def read_version(path: Union[str, Path], want: int
                 ) -> Tuple[int, List[Tuple[str, np.ndarray, np.ndarray]]]:
    """(codebook size, [(name, origins, indices)]) of a file in the v3
    layout whose version byte is `want`."""
    raw = Path(path).read_bytes()
    magic, version, grids, k, rank = HEADER.unpack_from(raw, 0)
    if magic != b"VQVDB" or version != want:
        raise ValueError(f"{path} is not a v{want} .vqvdb file")
    pos, out = HEADER.size, []
    for _ in range(grids):
        (n,) = struct.unpack_from("<I", raw, pos)
        name = raw[pos + 4:pos + 4 + n].decode()
        pos += 4 + n + 64
        latent = tuple(int(v) for v in np.frombuffer(raw, "<u2", rank, pos))
        pos += 2 * rank
        (leaves,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        dt = _chunk(int(np.prod(latent)), index_bytes(version, k))
        chunks = np.frombuffer(raw, dt, leaves, pos)
        pos += leaves * dt.itemsize
        out.append((name, chunks["origin"].copy(),
                    chunks["indices"].reshape((leaves,) + latent).copy()))
    if pos != len(raw):
        raise ValueError(f"{len(raw) - pos} trailing bytes in {path}")
    return k, out


def write(path: Union[str, Path], name: str, origins: np.ndarray, indices: np.ndarray,
          num_embeddings: int) -> None:
    """One grid: origins int32 [N, 3], indices uint8 [N, *latent]."""
    if num_embeddings > 256:
        raise ValueError("v3 holds one byte per index")
    write_version(path, 3, name, origins, indices, num_embeddings)


def read(path: Union[str, Path]) -> Tuple[int, List[Tuple[str, np.ndarray, np.ndarray]]]:
    """(codebook size, [(name, origins int32 [N, 3], indices uint8 [N, *latent])])."""
    return read_version(path, 3)
