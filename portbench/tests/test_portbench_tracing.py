"""The reduction of a trace: busy time, kernels and idle gaps."""

import torch

from portbench import tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start_us, dur_us, device=CPU, index=0, activity=""):
        self._n, self._s, self._d = name, int(start_us * 1000), int(dur_us * 1000)
        self._dev, self._i, self._a = device, index, activity

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def device_index(self):
        return self._i

    def activity_type(self):
        return self._a


def test_busy_kernels_and_gaps_of_a_window():
    events = [
        Ev(tracing.WINDOW, 100, 1000),
        Ev("portbench.decompress", 100, 900),
        Ev("portbench.decompress", 100, 900, CUDA, 0, "gpu_user_annotation"),  # no work
        Ev("aten::conv", 150, 100),
        Ev("cudaStreamSynchronize", 600, 250),
        Ev("k1", 50, 100, CUDA, 0, "kernel"),      # clipped to [100, 150]
        Ev("k1", 200, 100, CUDA, 0, "kernel"),
        Ev("k2", 250, 100, CUDA, 0, ""),            # overlaps k1: the union counts once
        Ev("Memcpy DtoH (Device -> Pinned)", 700, 100, CUDA, 0, ""),
    ]
    s = tracing.summarize(events, [0])
    assert abs(s["window_s"] - 1000e-6) < 1e-12
    assert abs(s["busy_s"] - (50 + 150 + 100) * 1e-6) < 1e-12
    assert set(s["kernels"]) == {"k1", "k2"} and s["kernels"]["k1"]["launches"] == 2
    assert abs(s["kernels"]["k1"]["seconds"] - 150e-6) < 1e-12
    assert set(s["device_ops"]) == {"k1", "k2", "Memcpy DtoH (Device -> Pinned)"}
    gaps = s["idle_gaps"]
    # [150, 200): its middle in aten::conv. [350, 700) and [800, 1100): their
    # middles (525, 950) held by no torch op, only by the harness's span.
    assert abs(gaps["aten::conv"] - 50e-6) < 1e-12
    assert abs(gaps["portbench.decompress: host code outside torch ops"] - 650e-6) < 1e-12
    assert abs(sum(gaps.values()) - (s["window_s"] - s["busy_s"])) < 1e-12


def test_top_keeps_the_largest():
    assert tracing.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]
