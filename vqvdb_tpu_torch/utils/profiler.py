"""Stage timers and trace ranges (counterpart of
`vqvdb_tpu/utils/profiler.py`).

`Profiler` accumulates host wall clock and a count per named stage; the
HTTP service reports it under `/stats`. `span(name)` only names a stretch
of work in a trace. Both open a range under their name whenever torch's
profiler is recording in the calling thread, whoever started it (a
`torch.profiler.profile` of the caller, the benchmark's traced run);
otherwise a stage costs two clock reads and a lock, and a span nothing but
the check. The range is a CPU event of the function scope, as a torch op's
is (`_RecordFunctionFast`): `torch.profiler.record_function`'s user scope
would also be mirrored onto the card's timeline, as a span over the kernels
launched inside it, which a reader of device time would count as work.

The codec's stages (`runtime/codec.py`, per batch unless said):

  init/weights          the weights onto the device (once, in the constructor)
  init/tail_fold        the decoder tail folded into one GEMM, or the final
                        conv folded before the shuffle (once)
  init/score_operand    the projection folded into the scores and the score
                        kernel's split operand, or the codebooks' (once)
  init/down_fold        the strided conv folded onto the packed grid (once)
  init/replicate        the constants copied to every device of a mesh (once)
  host/stage_in         the batch copied into the pinned input buffers
  host/pad              the ragged tail's padding zeroed
  device/dispatch       the upload, the device steps and the readback enqueued
  device/readback_wait  the host held until a batch's results are in its host
                        buffers (`_collect`: each slot's event waited on and,
                        on a mesh of several local cards, their rows gathered)
  host/scatter          `decompress`: the output grid allocated, a batch's rows
                        and origins copied into it, the grid closed (once more
                        per call)

Its spans: `host/file` (a `.vqvdb` file opened, or closed after writing),
`host/read_frames` (the reader's frames of a batch), `host/write_frames`
(the writer's), `device/read_back` (the readback's enqueue), and the parts
of a device step (`models/vqvae.py`, `models/blocks.py`, `ops/tail.py`):
`decode/dequantize`, `decode/stem`, `decode/rb` (vec3: `decode/rb1`,
`decode/rb2`), `decode/attention`, `decode/tail`; `encode/features` around
`encode/stem`, `encode/rb`, `encode/attention` (reference encoders:
`encode/pre_conv`, `encode/pre_rb`, `encode/down`, `encode/rb` or
`encode/rb1`, `encode/rb2`, `encode/attention`; and `encode/proj` without
the folded projection), then `encode/score_argmin` (or `encode/quantize`);
each residual block's halves `rb/conv1`, `rb/conv2`. Each part keeps the CPU
events it opens few, so a trace's reader that looks back a bounded number
of events from a moment finds the range that holds it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

_NO_RANGE = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A trace range named `name` while torch's profiler records in this
    thread; otherwise a context that does nothing."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _NO_RANGE


class Profiler:
    """Accumulating named stage timer (host wall clock). Safe to share
    between threads: a serving thread times stages while another reports."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
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

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._count.clear()
