"""Training data pipeline: mmap-backed npy leaf datasets + batch iterators
(counterpart of `vqvdb_tpu/train/data.py`, the same numpy code: for the same
seed and epoch the batches come in the JAX package's order).

Mirrors the reference's `VDBLeafDataset` capabilities (multi-file mmap npy
with cumulative offsets, scalar [N,8,8,8] or channels-last vec3
[N,8,8,8,3], optional origins sidecars, subsample stride, random split;
ref: python/VQVAE_v2.py:21-86 and training.py:60-95) — but vectorized for
accelerator feeding: batches are gathered with one fancy-index per step
(no per-item __getitem__/collate), channels-last throughout, and the
iterator yields fixed-shape arrays ready for the device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

from vqvdb_tpu_torch.core.config import LEAF_DIM

PathLike = Union[str, Path]


class LeafDataset:
    """Multi-file mmap leaf dataset with O(1) global indexing."""

    def __init__(
        self,
        npy_files: Sequence[PathLike],
        *,
        in_channels: int = 1,
        stride: int = 1,
    ) -> None:
        if not npy_files:
            raise ValueError("no .npy files given")
        self.in_channels = in_channels
        expected = (LEAF_DIM,) * 3 if in_channels == 1 else (LEAF_DIM,) * 3 + (in_channels,)
        self.arrays: List[np.ndarray] = []
        lengths = []
        for f in npy_files:
            arr = np.load(f, mmap_mode="r")
            if arr.shape[1:] != expected:
                raise ValueError(
                    f"{f}: shape {arr.shape} does not end with {expected}"
                )
            self.arrays.append(arr)
            lengths.append(arr.shape[0])
        self.offsets = np.cumsum([0] + lengths)
        # Subsample stride (ref training.py:67-68 uses stride 6).
        self.indices = np.arange(0, int(self.offsets[-1]), stride)

    def __len__(self) -> int:
        return len(self.indices)

    def gather(self, global_idx: np.ndarray) -> np.ndarray:
        """Gather a batch of leaves as channels-last f32 [B,8,8,8,C]."""
        gi = self.indices[global_idx]
        file_idx = np.searchsorted(self.offsets, gi, side="right") - 1
        out = np.empty((len(gi),) + (LEAF_DIM,) * 3 + (self.in_channels,), np.float32)
        # Group by file so each mmap is touched once per batch.
        for f in np.unique(file_idx):
            sel = file_idx == f
            local = gi[sel] - self.offsets[f]
            chunk = np.asarray(self.arrays[f][local], dtype=np.float32)
            if self.in_channels == 1:
                chunk = chunk[..., None]
            out[sel] = chunk
        return out

    def split(self, val_fraction: float = 0.2, seed: int = 0
              ) -> Tuple["DatasetView", "DatasetView"]:
        """Random train/val split (ref training.py:72-76: 80/20)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        n_val = int(len(self) * val_fraction)
        return (DatasetView(self, perm[n_val:]), DatasetView(self, perm[:n_val]))


class DatasetView:
    """A subset of a LeafDataset with its own index list."""

    def __init__(self, dataset: LeafDataset, subset: np.ndarray) -> None:
        self.dataset = dataset
        self.subset = np.asarray(subset)

    def __len__(self) -> int:
        return len(self.subset)

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
        epoch: int = 0,
    ) -> Iterator[np.ndarray]:
        """Yield [B,8,8,8,C] f32 batches. Fixed-shape when drop_remainder
        (one shape for every step); the tail pads by wrapping
        when drop_remainder=False."""
        order = self.subset
        if shuffle:
            order = np.random.default_rng(seed + epoch).permutation(self.subset)
        n = len(order)
        stop = n - (n % batch_size) if drop_remainder else n
        for s in range(0, stop, batch_size):
            idx = order[s : s + batch_size]
            if len(idx) < batch_size:  # only when not dropping remainder
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            yield self.dataset.gather(idx)


def find_npy_files(data_dir: PathLike) -> List[Path]:
    """All leaf .npy files in a directory, excluding origin sidecars."""
    files = sorted(Path(data_dir).glob("*.npy"))
    return [f for f in files if not f.name.endswith("_origins.npy")]
