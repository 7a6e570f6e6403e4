"""Sparse leaf grid and quality metrics (counterpart of
`vqvdb_tpu/vdb/grid.py`).

    origins : int32 [N, 3]          leaf origins in index space (multiples of 8)
    leaves  : f32   [N, 8, 8, 8, C] voxel payloads (channels-last)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from vqvdb_tpu_torch.core.config import LEAF_DIM


@dataclasses.dataclass
class LeafGrid:
    """A named sparse volume as (origins, leaf blocks) + index->world affine."""

    name: str
    origins: np.ndarray  # (N, 3) int32, multiples of LEAF_DIM
    leaves: np.ndarray  # (N, 8, 8, 8, C) float32
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    background: float = 0.0

    def __post_init__(self) -> None:
        self.origins = np.ascontiguousarray(self.origins, dtype=np.int32).reshape(-1, 3)
        leaves = np.asarray(self.leaves, dtype=np.float32)
        if leaves.ndim == 4:  # (N, 8, 8, 8) -> scalar channel
            leaves = leaves[..., None]
        if leaves.shape[1:4] != (LEAF_DIM, LEAF_DIM, LEAF_DIM):
            raise ValueError(f"leaves must be (N,8,8,8[,C]); got {leaves.shape}")
        self.leaves = np.ascontiguousarray(leaves)
        self.transform = np.asarray(self.transform, dtype=np.float32).reshape(4, 4)
        if self.origins.shape[0] != self.leaves.shape[0]:
            raise ValueError(
                f"{self.origins.shape[0]} origins vs {self.leaves.shape[0]} leaves"
            )

    @property
    def num_leaves(self) -> int:
        return int(self.leaves.shape[0])

    @property
    def channels(self) -> int:
        return int(self.leaves.shape[-1])

    def index_bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        """(min_corner, max_corner_exclusive) over all leaves, index space."""
        if self.num_leaves == 0:
            z = np.zeros(3, np.int32)
            return z, z
        return self.origins.min(axis=0), self.origins.max(axis=0) + LEAF_DIM

    @classmethod
    def from_dense(
        cls,
        name: str,
        dense: np.ndarray,
        *,
        origin: Tuple[int, int, int] = (0, 0, 0),
        transform: Optional[np.ndarray] = None,
        background: float = 0.0,
        tolerance: float = 0.0,
    ) -> "LeafGrid":
        """Extract active 8^3 leaves from a dense array (X, Y, Z[, C]): a
        leaf is active when any voxel deviates from `background` by more
        than `tolerance`."""
        dense = np.asarray(dense, dtype=np.float32)
        if dense.ndim == 3:
            dense = dense[..., None]
        x, y, z, c = dense.shape
        ld = LEAF_DIM
        px, py, pz = (-x) % ld, (-y) % ld, (-z) % ld
        if px or py or pz:
            dense = np.pad(
                dense, ((0, px), (0, py), (0, pz), (0, 0)),
                constant_values=background,
            )
            x, y, z, _ = dense.shape
        nx, ny, nz = x // ld, y // ld, z // ld
        blocks = dense.reshape(nx, ld, ny, ld, nz, ld, c)
        blocks = blocks.transpose(0, 2, 4, 1, 3, 5, 6).reshape(-1, ld, ld, ld, c)
        active = np.abs(blocks - background).max(axis=(1, 2, 3, 4)) > tolerance
        (flat_idx,) = np.nonzero(active)
        bi = np.stack(np.unravel_index(flat_idx, (nx, ny, nz)), axis=1)
        origins = (bi * ld + np.asarray(origin, np.int32)).astype(np.int32)
        return cls(
            name=name,
            origins=origins,
            leaves=blocks[flat_idx],
            transform=np.eye(4, dtype=np.float32) if transform is None else transform,
            background=background,
        )

    def to_dense(self) -> Tuple[np.ndarray, np.ndarray]:
        """Scatter leaves into a dense array over the grid's bounding box:
        (dense (X,Y,Z,C) f32, min_corner (3,) i32)."""
        lo, hi = self.index_bbox()
        ld = LEAF_DIM
        nx, ny, nz = (int(e) // ld for e in hi - lo)
        c = self.channels
        if self.num_leaves == 0:
            return np.zeros((0, 0, 0, c), np.float32), lo
        grid_blocks = np.full((nx, ny, nz, ld, ld, ld, c), self.background, np.float32)
        bi = (self.origins - lo) // ld
        grid_blocks[bi[:, 0], bi[:, 1], bi[:, 2]] = self.leaves
        dense = grid_blocks.transpose(0, 3, 1, 4, 2, 5, 6).reshape(
            nx * ld, ny * ld, nz * ld, c
        )
        return dense, lo


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB against `peak` (1.0 for the scalar model's [0, 1] range)."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))
