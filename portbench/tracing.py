"""The traced run: spans from the harness, and the reduction of a
`torch.profiler` trace to what the per-layer metrics read.

`Tracer` wraps the timed window in `torch.profiler.profile` (CPU and CUDA
activity). The harness opens a span (`record_function`) around the whole
window (`WINDOW`) and around each call into the codec. `summarize` then reads
the profiler's raw events once:

  busy_s      per device, the union of its kernels, copies and fills inside
              the window (the harness's spans, which the profiler mirrors onto
              the device's timeline, are no work), averaged over the devices
              the run uses
  kernels     total seconds and launches of each device kernel, by name
  device_ops  total seconds of each kernel, copy and fill, by name
  idle_gaps   the gaps between device work, each charged to what the host
              was doing at its middle: the innermost CPU event (a torch op, a
              CUDA runtime call, a harness span) that holds it; gaps under
              SMALL_GAP_S are charged together
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"
SMALL_GAP_S = 20e-6
# How far back (in CPU events) to look for the innermost one holding a gap.
LOOKBACK = 256


class Tracer:
    """Context around the window; `summary` is set once it has closed."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[Dict] = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.enabled else contextlib.nullcontext()

    def summarize(self, devices: List[int]) -> Dict:
        self.summary = summarize(self._prof.profiler.kineto_results.events(), devices)
        self._prof = None
        return self.summary


def _activity(e) -> str:
    try:
        return str(e.activity_type())
    except (AttributeError, RuntimeError):
        return ""


def _device_kind(name: str, activity: str) -> Optional[str]:
    """"kernel", "copy" (a copy or fill) or None (a span mirrored onto the
    device's timeline, which is no work), from the profiler's activity type
    where this torch gives one and from the event's name where it does not."""
    if name.startswith(SPAN_PREFIX) or "annotation" in activity:
        return None
    if activity in ("gpu_memcpy", "gpu_memset") or name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "kernel" if activity in ("kernel", "") else None


def _union(starts: np.ndarray, ends: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """(covered length, merged starts, merged ends) of intervals."""
    if starts.size == 0:
        return 0.0, starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    ms, me = s[first], np.append(e[first[1:] - 1], e[-1])
    return float((me - ms).sum()), ms, me


def summarize(events, devices: List[int]) -> Dict:
    """Reduce the profiler's raw events (kineto events) of one traced window."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    cpu: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    dev: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    kern_s: Dict[str, float] = collections.defaultdict(float)
    kern_n: Dict[str, int] = collections.defaultdict(int)
    ops_s: Dict[str, float] = collections.defaultdict(float)
    device_raw: List[Tuple[int, int, int, str, str]] = []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            device_raw.append((e.device_index(), start, start + dur, e.name(), _activity(e)))
            continue
        name = e.name()
        if name == WINDOW:
            window = (start, start + dur)
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, start + dur, name))
        else:
            cpu.append((start, start + dur, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window
    for index, s, t, name, act in device_raw:
        s, t = max(s, w0), min(t, w1)
        kind = _device_kind(name, act)
        if t <= s or kind is None:
            continue
        dev[index].append((s, t))
        ops_s[name] += (t - s) * 1e-9
        if kind == "kernel":
            kern_s[name] += (t - s) * 1e-9
            kern_n[name] += 1
    cpu.sort()
    c_start = np.array([c[0] for c in cpu], np.int64)
    c_end = np.array([c[1] for c in cpu], np.int64)
    busy, gaps = [], collections.defaultdict(float)
    for d in devices:
        iv = np.array(dev.get(d, []), np.int64).reshape(-1, 2)
        covered, ms, me = _union(iv[:, 0], iv[:, 1])
        busy.append(covered * 1e-9)
        edges_s = np.concatenate([[w0], me])
        edges_e = np.concatenate([ms, [w1]])
        for gs, ge in zip(edges_s, edges_e):
            length = (ge - gs) * 1e-9
            if length <= 0:
                continue
            if length < SMALL_GAP_S:
                gaps[f"gaps under {SMALL_GAP_S * 1e6:.0f} us"] += length / len(devices)
                continue
            gaps[_holder(cpu, c_start, c_end, spans, (gs + ge) // 2)] += length / len(devices)
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": float(np.mean(busy)) if busy else 0.0,
        "busy_by_device": busy,
        "kernels": {k: {"seconds": kern_s[k], "launches": kern_n[k]} for k in kern_s},
        "device_ops": dict(ops_s),
        "idle_gaps": dict(gaps),
    }


def _holder(cpu, starts: np.ndarray, ends: np.ndarray, spans, t: int) -> str:
    """What the host did at time t: the innermost CPU event that holds it
    (the latest start among the last LOOKBACK events), else the harness
    span that holds it (host code that runs no torch op), else nothing."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - LOOKBACK, -1), -1):
        if ends[j] >= t:
            return cpu[j][2]
    for s, e, name in spans:
        if s <= t <= e:
            return f"{name}: host code outside torch ops"
    return "between the harness's calls"


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    """The n largest entries of {name: seconds} as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
