"""What the per-layer metric files share: each reads a run's record (the
`Record` of `harness.py`) and returns a number, or None when the run holds
nothing for it to read (another direction, no trace, no such kernel); the
harness then leaves the metric out of the line."""

from __future__ import annotations

from typing import Optional

from portbench.counts import kernels

LATENT_ROWS = 64  # latent positions of a leaf


def dispatch_ms_per_batch(rec, direction: str) -> Optional[float]:
    """Host ms per device batch of the codec's `device/dispatch` stage (its
    own `Profiler`): the enqueue of a batch's upload, steps and readback."""
    st = rec.stages.get("device/dispatch")
    if rec.direction != direction or not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]


def host_ms_per_frame(rec, direction: str, key: str) -> Optional[float]:
    """Host ms per frame of one `host_seconds` entry of the codec's stats."""
    if rec.direction != direction or key not in rec.host_seconds or not rec.frames:
        return None
    return 1e3 * rec.host_seconds[key] / rec.frames


def device_ms_per_batch(rec, direction: str) -> Optional[float]:
    """Device kernel ms per global batch, summed over the cards."""
    if rec.direction != direction or rec.trace is None or not rec.batches:
        return None
    total = sum(k["seconds"] for k in rec.trace["kernels"].values())
    return 1e3 * total / rec.batches if total > 0 else None


def idle_share(rec, direction: str) -> Optional[float]:
    """% of the traced window in which a card ran nothing (mean over cards)."""
    if (rec.direction != direction or rec.trace is None or rec.trace["window_s"] <= 0
            or rec.trace["busy_s"] <= 0):
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])


def mfu(rec, direction: str) -> Optional[float]:
    """% of the cards' bf16 peak: leaves in the window times the plain
    model's operations a leaf (`rec.flops_per_leaf`), over the window's
    seconds."""
    if (rec.direction != direction or rec.peaks is None or rec.window_s <= 0 or not rec.leaves
            or not rec.flops_per_leaf):
        return None
    ops = rec.leaves * rec.flops_per_leaf
    return 100.0 * ops / (rec.window_s * rec.peaks["bf16_flops_per_s"] * rec.chips)


def _kernel(rec, pattern: str):
    """(seconds, launches) of the device kernels whose name holds `pattern`."""
    sec = launches = 0
    for name, k in rec.trace["kernels"].items():
        if pattern in name:
            sec += k["seconds"]
            launches += k["launches"]
    return sec, launches


def roofline(rec, direction: str, pattern: str, count) -> Optional[float]:
    """% of its roofline of a kernel: the least time its work needs at the
    card's peaks (`count(rec, launches)` -> (bytes, operations)) over the
    kernel's time in the trace. Sets `rec.bounds[pattern]` to the bound's
    name ("bytes" or "operations")."""
    if rec.direction != direction or rec.trace is None or rec.peaks is None:
        return None
    sec, launches = _kernel(rec, pattern)
    if sec <= 0:
        return None
    nbytes, ops = count(rec, launches)
    least, by = kernels.bound_seconds(nbytes, ops, rec.peaks)
    rec.bounds[pattern] = by
    return 100.0 * least / sec


def dequantize_work(rec, launches: int):
    s = rec.sizes
    return kernels.dequantize(rec.leaves * LATENT_ROWS, launches, s["num_embeddings"],
                              s["embedding_dim"], rec.value_bytes)


def score_argmin_work(rec, launches: int):
    s = rec.sizes
    return kernels.score_argmin(rec.leaves * LATENT_ROWS, launches, s["encoder_width"],
                                s["num_embeddings"], rec.value_bytes)
