"""Frozen v4 `.vqvdb` writer and reader: v3's chunk layout (`v3.py`) with
version byte 4, whose indices are u8 for up to 256 codes and little-endian
u16 beyond."""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from portbench.reference import v3


def write(path: Union[str, Path], name: str, origins: np.ndarray, indices: np.ndarray,
          num_embeddings: int) -> None:
    """One grid: origins int32 [N, 3], indices [N, *latent] below `num_embeddings`."""
    if not 1 <= num_embeddings <= 65536:
        raise ValueError("v4 holds at most 65,536 codes")
    v3.write_version(path, 4, name, origins, indices, num_embeddings)


def read(path: Union[str, Path]) -> Tuple[int, List[Tuple[str, np.ndarray, np.ndarray]]]:
    """(codebook size, [(name, origins int32 [N, 3], indices uint8 or uint16
    [N, *latent])])."""
    return v3.read_version(path, 4)
