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

A device stage (`device_stage(name, like)`) is timed on the card instead,
and opens no range: while torch's profiler records, a pipeline's dispatch
of a batch gathers (`Profiler.device_times`) the two CUDA events that each
device stage records on the current stream around its section, and their
time is added under the stage's name once the batch's results are in
(`DeviceTimes.settle`), so it adds no synchronisation. Otherwise, and on
the CPU, a device stage does nothing.

The codec's stages (`runtime/codec.py`, per batch unless said):

  init/weights          the weights onto the device (once, in the constructor)
  init/tail_fold        the decoder tail folded into one GEMM, and the decoder
                        head's operator and weights prepared (once)
  init/score_operand    the projection folded into the scores and the score
                        kernel's split operand, or a residual-VQ model's
                        prepared codebooks (once)
  init/down_fold        the strided conv of a single-stage model's reference
                        encoder folded onto the packed grid (once)
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
  device/encode_fine    a device stage, traced runs on the card only: the
                        reference encoders' 8^3 stage (`models/vqvae.py`
                        `_reference_pre`: the pre conv, GroupNorm, relu and the
                        pre residual block), one count a device step (each
                        shard's on a mesh), read in `_collect`

Its spans: `host/file` (a `.vqvdb` file opened, or closed after writing),
`host/read_frames` (the reader's frames of a batch), `host/write_frames`
(the writer's), `device/read_back` (the readback's enqueue), and the parts
of a device step (`runtime/codec.py`, `models/vqvae.py`, `models/blocks.py`):
`decode/dequantize`, `decode/stem`, `decode/rb` (vec3: `decode/rb1`,
`decode/rb2`), `decode/head` (the channel attention and the folded tail;
its plain version, and the unfolded graph outside the codec, open
`decode/attention` and `decode/tail`);
`encode/features` around
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
from typing import ContextManager, Dict, Iterator, List, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

_NO_RANGE = contextlib.nullcontext()
# The DeviceTimes that this thread's device stages record into, or None: the
# model's functions, which open the stages, are handed no profiler.
_gathering = threading.local()


def span(name: str) -> ContextManager:
    """A trace range named `name` while torch's profiler records in this
    thread; otherwise a context that does nothing."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _NO_RANGE


class _DeviceStage:
    """Two CUDA events recorded on the current stream around a section."""

    __slots__ = ("name", "pairs", "start")

    def __init__(self, name: str, pairs: list) -> None:
        self.name, self.pairs = name, pairs

    def __enter__(self) -> None:
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def __exit__(self, *exc) -> bool:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.pairs.append((self.name, self.start, end))
        return False


def device_stage(name: str, like: torch.Tensor) -> ContextManager:
    """A stage named `name` timed on the card, around work on `like`'s
    device: its events join the batch whose dispatch this thread is
    gathering (`Profiler.device_times`); outside one, or with `like` off the
    card, a context that does nothing."""
    times = getattr(_gathering, "times", None)
    if times is None or not like.is_cuda:
        return _NO_RANGE
    return _DeviceStage(name, times.pairs)


class DeviceTimes:
    """The event pairs that this thread's device stages record while it is
    entered (one batch's dispatch); `settle` adds their times to the
    profiler once they have completed."""

    __slots__ = ("profiler", "pairs")

    def __init__(self, profiler: "Profiler") -> None:
        self.profiler = profiler
        self.pairs: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def __enter__(self) -> "DeviceTimes":
        _gathering.times = self
        return self

    def __exit__(self, *exc) -> bool:
        _gathering.times = None
        return False

    def settle(self) -> None:
        """Add each pair's time under its stage's name. Call it once the
        batch's results are in: the events then have completed, and reading
        them waits for nothing."""
        for name, start, end in self.pairs:
            self.profiler.add(name, start.elapsed_time(end) / 1e3)
        self.pairs.clear()


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
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Count one run of stage `name` that took `seconds`."""
        with self._lock:
            self._total[name] += seconds
            self._count[name] += 1

    def device_times(self) -> ContextManager:
        """While torch's profiler records in this thread: a `DeviceTimes`
        that gathers the device stages recorded while it is entered;
        otherwise a context that gives None and does nothing."""
        return DeviceTimes(self) if _profiler_enabled() else _NO_RANGE

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
