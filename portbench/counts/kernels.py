"""Bytes and operations that the dequantize and score-argmin steps need.

dequantize: each index read once (1 byte for K <= 256, 2 beyond: the
narrowest that holds it, as v3 and v4 store it), the codebook once per
launch and each output row of D values written once, in the compute dtype.
score-argmin: the encoder features (F values a row, compute dtype), the
folded score matrix (F x K float32 and K float32 offsets) once per launch,
and one index a row (1 or 2 bytes, as above); 2 F K operations a row.
A share of the roofline is the least time these need at the card's peaks
(the larger of bytes over bandwidth and operations over the bf16 rate) over
the kernels' time.
"""

from __future__ import annotations

from typing import Dict, Tuple


def index_bytes(k: int) -> int:
    """Bytes of one index into K codes."""
    return 1 if k <= 256 else 2


def dequantize(rows: int, launches: int, k: int, d: int, value_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of dequantizing `rows` latent rows in `launches` launches."""
    return rows * index_bytes(k) + launches * k * d * value_bytes + rows * d * value_bytes, 0.0


def score_argmin(rows: int, launches: int, f: int, k: int, value_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of scoring `rows` feature rows against K codes."""
    return (rows * f * value_bytes + launches * (f * k + k) * 4 + rows * index_bytes(k),
            2.0 * rows * f * k)


def bound_seconds(nbytes: float, ops: float, peaks: Dict) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations": which bound governs)."""
    by_bytes = nbytes / peaks["hbm_bytes_per_s"]
    by_ops = ops / peaks["bf16_flops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
