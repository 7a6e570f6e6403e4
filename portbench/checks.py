"""The comparison that decides `correct`: what the timed window produced
against the plain reference, each number against the limit the cell's
limits file gives it.

Decode (the program's `decompress` of a frame file -> LeafGrid):
  origins_off    leaves whose origin differs from the file's, plus any
                 difference in the leaf count (exact: limit 0)
  leaf_max_abs   the largest |program - reference| over every voxel
  leaf_rel_rms   the root-mean-square of program - reference over that of
                 the reference
Encode (the program's `compress` of a frame -> a file):
  origins_off    leaves whose origin in the file differs from the frame's,
                 plus any difference in the leaf count (exact: limit 0)
  index_mismatch_share   latent rows whose index differs from the
                 reference's nearest code
  regret_share   the summed excess distance of the program's codes over the
                 nearest code, over the summed nearest distance, all from the
                 reference's latent rows (in float64)
  leaf_regret_max  the largest excess distance of one leaf's 64 codes, over
                 the mean nearest distance of a leaf: a leaf coded wrongly
                 shows here however many leaves are right

The reference runs after the window has closed and the program's state is
freed, in blocks of rows, on the device the window ran on: BLOCK leaves a
block to decode, `encode_block(K)` to encode, which holds the float64
distance matrix of a block near 0.5 GB at any K. Indices reach torch as
int64, from u8 or u16 files alike.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

BLOCK = 4096


def encode_block(num_embeddings: int) -> int:
    """Leaves a block of the encode check: BLOCK up to 256 codes, fewer beyond
    (64 rows a leaf, K float64 distances a row)."""
    return BLOCK * 256 // max(num_embeddings, 256)


def indices_tensor(indices: np.ndarray, device: torch.device) -> torch.Tensor:
    """A block of file indices (u8 or u16) as int64 on `device`."""
    return torch.from_numpy(indices.astype(np.int64)).to(device)


class Tally:
    """Running sums of one cell's comparison numbers."""

    def __init__(self, direction: str):
        self.direction = direction
        self.origins_off = 0
        self.max_abs = 0.0
        self.sq_err = self.sq_ref = 0.0
        self.rows = self.mismatch = 0
        self.regret = self.nearest = 0.0
        self.leaves = 0
        self.leaf_regret = 0.0

    def numbers(self) -> Dict[str, float]:
        if self.direction == "decode":
            return {"origins_off": float(self.origins_off), "leaf_max_abs": self.max_abs,
                    "leaf_rel_rms": float(np.sqrt(self.sq_err / max(self.sq_ref, 1e-300)))}
        return {"origins_off": float(self.origins_off),
                "index_mismatch_share": self.mismatch / max(self.rows, 1),
                "regret_share": self.regret / max(self.nearest, 1e-300),
                "leaf_regret_max": self.leaf_regret * self.leaves / max(self.nearest, 1e-300)}


def _origins_off(got: np.ndarray, want: np.ndarray) -> int:
    n = min(got.shape[0], want.shape[0])
    return int(np.any(got[:n] != want[:n], axis=1).sum()) + abs(got.shape[0] - want.shape[0])


@torch.inference_mode()
def decode_frame(tally: Tally, model, file_origins: np.ndarray, file_indices: np.ndarray,
                 got_origins: np.ndarray, got_leaves: np.ndarray, device: torch.device) -> None:
    """One decoded frame against the reference's decode of its file."""
    tally.origins_off += _origins_off(got_origins, file_origins)
    n = min(got_leaves.shape[0], file_indices.shape[0])
    for s in range(0, n, BLOCK):
        ref = model.decode(indices_tensor(file_indices[s:s + BLOCK], device))
        got = torch.from_numpy(np.ascontiguousarray(got_leaves[s:s + BLOCK])).to(device)
        diff = (got.to(torch.float64) - ref.to(torch.float64))
        tally.max_abs = max(tally.max_abs, float(diff.abs().max()))
        tally.sq_err += float((diff * diff).sum())
        tally.sq_ref += float((ref.to(torch.float64) ** 2).sum())


@torch.inference_mode()
def encode_frame(tally: Tally, model, leaves: np.ndarray, origins: np.ndarray,
                 file_origins: np.ndarray, file_indices: np.ndarray,
                 device: torch.device, control=None) -> None:
    """One written frame against the reference's encode of its leaves. With
    `control` (a reference model in a lower precision) the control's codes
    are judged in the program's place."""
    tally.origins_off += _origins_off(file_origins, origins)
    n = min(leaves.shape[0], file_indices.shape[0])
    book = model.codebook.to(torch.float64)
    book_sq = (book * book).sum(dim=1)
    block = encode_block(book.shape[0])
    for s in range(0, n, block):
        x = torch.from_numpy(np.ascontiguousarray(leaves[s:s + block])).to(device)
        z = model.latent(x).to(torch.float64)
        dist = (z * z).sum(dim=1, keepdim=True) - 2.0 * z @ book.T + book_sq
        if control is None:
            got = indices_tensor(file_indices[s:s + block].reshape(-1), device)
        else:
            got = control.encode(x).reshape(-1)
        best, best_idx = dist.min(dim=1)
        mine = dist.gather(1, got[:, None])[:, 0]
        tally.rows += int(got.numel())
        tally.mismatch += int((got != best_idx).sum())
        excess = (mine - best).clamp(min=0)
        tally.regret += float(excess.sum())
        tally.nearest += float(best.clamp(min=0).sum())
        tally.leaves += x.shape[0]
        tally.leaf_regret = max(tally.leaf_regret, float(excess.reshape(x.shape[0], -1).sum(dim=1).max()))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Dict]]:
    """(every number within its limit, [{name, value, limit, ok}]). A number
    without a limit, or a limit without a number, fails."""
    rows, ok = [], True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        good = value is not None and limit is not None and bool(np.isfinite(value)) and value <= limit
        ok &= good
        rows.append({"name": name, "value": value, "limit": limit, "ok": good})
    return ok, rows
