"""Stage timers and device tracing (counterpart of
`vqvdb_tpu/utils/profiler.py`).

`Profiler` accumulates host wall clock per named stage; the codec times its
`host/pad` and `device/dispatch` stages with it and the HTTP service reports
it under `/stats`. `trace(log_dir)` records a `torch.profiler` trace of the
CPU and the card into `log_dir` (a Chrome trace, viewable in Perfetto), the
counterpart of the JAX package's `jax.profiler` trace. While a trace runs,
every stage timer also opens a `record_function` range under its stage's
name, so the trace names the stages; outside a trace a timer costs two clock
reads.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

# Depth of `trace` contexts open in this process: stage timers open a
# record_function range only inside one.
_tracing = 0


class Profiler:
    """Accumulating named stage timer (host wall clock). Safe to share
    between threads: a serving thread times stages while another reports."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        rng = torch.profiler.record_function(name) if _tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with rng:
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._total[name] += dt
                self._count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": self._total[name],
                    "count": self._count[name],
                    "mean_ms": 1e3 * self._total[name] / max(self._count[name], 1),
                }
                for name in sorted(self._total)
            }

    def print_report(self) -> None:
        for name, row in self.report().items():
            print(f"[profile] {name:<24} total={row['total_s']:.3f}s "
                  f"n={row['count']} mean={row['mean_ms']:.2f}ms")

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._count.clear()


@contextlib.contextmanager
def scoped_timer(name: str, log_fn=print) -> Iterator[None]:
    """One-shot timer that logs its stage's milliseconds when it closes."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log_fn(f"[timer] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """A torch.profiler trace of the CPU and (when there is one) the card,
    written to `log_dir/trace.json`. No-op when log_dir is None, so call
    sites can leave it wired in."""
    global _tracing
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        _tracing += 1
        try:
            yield
        finally:
            _tracing -= 1
    prof.export_chrome_trace(str(out / "trace.json"))
