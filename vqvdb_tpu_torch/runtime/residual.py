"""Residual-correction math for the v6 near-lossless tier (counterpart of
`vqvdb_tpu/runtime/residual.py`, the same numpy code, so that the same
reconstruction gives the same bytes).

The correction is computed and applied on the host, against
reconstructions from the codec's ordinary decode step at its batch size
(`VQCodec._decode_step`). The encode-time and the decode-time
reconstructions then come from the same launches on rows of the same
indices, so they are bit-identical and the per-voxel error of the corrected
output is bounded by quantization alone:

  int8 mode: |x - (x_hat + s*q)| <= s/2,   s = max|x - x_hat| / 127 per leaf
  f16  mode: |x - (x_hat + e16)| = |e - f16(e)|  (one half-precision rounding)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

RESIDUAL_MODES = ("int8", "f16")


def quantize_residual(err: np.ndarray, mode: str, tol: Optional[float] = None
                      ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Quantize per-leaf reconstruction errors for storage.

    err: f32 [n, 8, 8, 8, C] (any [n, ...] layout; flattened per leaf).
    Returns (scales f32 [n] | None, residual i8/f16 [n, voxels*C]).

    tol (int8 mode): target max absolute error; the quantization step is
    floored at 2*tol, so leaves already close to exact quantize to mostly
    zero codes. Bound: per-voxel error <= max(leaf_max_err/254, tol).
    """
    if mode not in RESIDUAL_MODES:
        raise ValueError(f"unknown residual mode {mode!r}")
    n = err.shape[0]
    flat = np.ascontiguousarray(err, np.float32).reshape(n, -1)
    if mode == "f16":
        if tol is not None:
            raise ValueError("tol applies to the int8 mode only")
        return None, flat.astype(np.float16)
    amax = np.abs(flat).max(axis=1)
    scales = np.maximum(amax / 127.0, 1e-12)
    if tol is not None:
        scales = np.maximum(scales, 2.0 * float(tol))
    scales = scales.astype(np.float32)
    q = np.rint(flat / scales[:, None])
    return scales, np.clip(q, -127, 127).astype(np.int8)


def apply_residual(rec: np.ndarray, scales: Optional[np.ndarray],
                   residual: Optional[np.ndarray]) -> np.ndarray:
    """Add the stored correction to reconstructions, in place.

    rec: f32 [n, 8, 8, 8, C]; residual rows are reshaped to match.
    Returns rec (corrected) for convenience.
    """
    if residual is None or rec.shape[0] == 0:
        return rec
    r = residual.astype(np.float32).reshape(rec.shape)
    if scales is not None:
        r *= scales.reshape((-1,) + (1,) * (rec.ndim - 1))
    rec += r
    return rec
