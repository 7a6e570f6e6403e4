"""Quality evaluation harness (counterpart of `vqvdb_tpu/eval/metrics.py`)
— the programmatic equivalent of the reference's notebook acceptance suite
(ref: notebook_scalar.ipynb cells 1-9, notebook_vec3f.ipynb cells 3-14):

  * full-set encode/decode round trip over a leaf dataset;
  * per-block MSE / PSNR distributions (peak=1.0, PSNR = -10*log10(MSE));
  * zero-voxel vs non-zero-voxel MSE split (the headline numbers:
    1.21e-05 / 1.79e-04 on the reference's val set, BASELINE.md);
  * codebook usage histogram, dead-code count, perplexity and
    active-code ratio.

Everything returns plain dicts/arrays so the CLI can emit JSON and tests
can assert thresholds — no notebook required. `eval_backend` names the
device type the codec ran on ("cuda" or "cpu"), where the JAX package
names its JAX backend.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def evaluate_codec(codec, leaves: np.ndarray, *, zero_atol: float = 0.0,
                   max_leaves: Optional[int] = None) -> Dict:
    """Round-trip leaves [N,8,8,8,C] (or [N,8,8,8]) through the codec and
    report per-block and aggregate quality metrics."""
    leaves = np.asarray(leaves, np.float32)
    if leaves.ndim == 4:
        leaves = leaves[..., None]
    if max_leaves is not None:
        leaves = leaves[:max_leaves]
    n = leaves.shape[0]

    indices = codec.encode_leaves(leaves)
    recon = codec.decode_indices(indices)

    err = (recon.astype(np.float64) - leaves.astype(np.float64)) ** 2
    per_block_mse = err.reshape(n, -1).mean(axis=1)
    with np.errstate(divide="ignore"):
        per_block_psnr = -10.0 * np.log10(per_block_mse)

    zero_mask = np.abs(leaves) <= zero_atol
    zero_mse = float(err[zero_mask].mean()) if zero_mask.any() else 0.0
    nonzero_mse = float(err[~zero_mask].mean()) if (~zero_mask).any() else 0.0

    finite_psnr = per_block_psnr[np.isfinite(per_block_psnr)]
    return {
        "num_blocks": int(n),
        # Provenance: a bf16 eval on one device and an f32 eval on another
        # differ on the same artifact; stamping the basis makes a mixed
        # citation detectable.
        "eval_backend": codec.device.type,
        "compute_dtype": str(codec.ccfg.compute_dtype),
        "mse": float(per_block_mse.mean()),
        "psnr_mean": float(finite_psnr.mean()) if finite_psnr.size else float("inf"),
        "psnr_p5": float(np.percentile(finite_psnr, 5)) if finite_psnr.size else float("inf"),
        "psnr_p50": float(np.percentile(finite_psnr, 50)) if finite_psnr.size else float("inf"),
        "zero_voxel_mse": zero_mse,
        "nonzero_voxel_mse": nonzero_mse,
        "per_block_mse": per_block_mse,
        "per_block_psnr": per_block_psnr,
        "indices": indices,
    }


def codebook_report(indices: np.ndarray, num_embeddings: int,
                    dead_threshold: int = 0) -> Dict:
    """Codebook usage audit (ref: notebook_vec3f.ipynb usage histogram /
    dead-code / perplexity cells)."""
    flat = np.asarray(indices).reshape(-1)
    counts = np.bincount(flat, minlength=num_embeddings).astype(np.float64)
    probs = counts / max(flat.size, 1)
    nz = probs[probs > 0]
    perplexity = float(np.exp(-(nz * np.log(nz)).sum())) if nz.size else 0.0
    active = int((counts > dead_threshold).sum())
    return {
        "counts": counts,
        "active_codes": active,
        "dead_codes": int(num_embeddings - active),
        "active_ratio": active / num_embeddings,
        "perplexity": perplexity,
        "total_assignments": int(flat.size),
    }
