"""Sparse leaf grid and quality metrics (counterpart of
`vqvdb_tpu/vdb/grid.py`).

    origins : int32 [N, 3]          leaf origins in index space (multiples of 8)
    leaves  : f32   [N, 8, 8, 8, C] voxel payloads (channels-last)
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple, Union

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

    @property
    def active_voxel_count(self) -> int:
        return self.num_leaves * LEAF_DIM**3

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

    def save_npy(self, path: Union[str, Path], *, with_origins: bool = True) -> None:
        """Save leaves as [N,8,8,8] (scalar) / [N,8,8,8,C] .npy, with an
        `*._origins.npy` sidecar and a `*.gridmeta.json` of name,
        background and transform (the JAX package's layout)."""
        path = Path(path)
        np.save(path, self.leaves[..., 0] if self.channels == 1 else self.leaves)
        if with_origins:
            np.save(path.with_suffix("._origins.npy"), self.origins)
        meta = {"name": self.name, "background": self.background,
                "transform": self.transform.tolist()}
        path.with_suffix(".gridmeta.json").write_text(json.dumps(meta))

    @classmethod
    def load_npy(cls, path: Union[str, Path], *, name: Optional[str] = None) -> "LeafGrid":
        """Read what `save_npy` writes. Without an origins sidecar the
        leaves get row-major origins on a cube; without the json the name
        is the file's stem (or `name`)."""
        path = Path(path)
        leaves = np.load(path)
        origins_path = path.with_suffix("._origins.npy")
        if origins_path.exists():
            origins = np.load(origins_path)
        else:
            n = leaves.shape[0]
            side = int(np.ceil(n ** (1.0 / 3.0)))
            origins = np.stack(np.unravel_index(np.arange(n), (side, side, side)),
                               axis=1).astype(np.int32) * LEAF_DIM
        meta_path = path.with_suffix(".gridmeta.json")
        transform = np.eye(4, dtype=np.float32)
        background = 0.0
        gname = name or path.stem
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            gname = name or meta.get("name", gname)
            transform = np.asarray(meta.get("transform", transform), np.float32)
            background = float(meta.get("background", 0.0))
        return cls(name=gname, origins=origins, leaves=leaves,
                   transform=transform, background=background)


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB against `peak` (1.0 for the scalar model's [0, 1] range)."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def split_mse(recon: np.ndarray, target: np.ndarray, atol: float = 0.0
              ) -> Tuple[float, float]:
    """(zero-voxel MSE, non-zero-voxel MSE), the voxels split on |target| <=
    atol; 0.0 for an empty side."""
    target = np.asarray(target, np.float64)
    recon = np.asarray(recon, np.float64)
    zero_mask = np.abs(target) <= atol
    err = (recon - target) ** 2
    zero_mse = float(err[zero_mask].mean()) if zero_mask.any() else 0.0
    nz = ~zero_mask
    nonzero_mse = float(err[nz].mean()) if nz.any() else 0.0
    return zero_mse, nonzero_mse
