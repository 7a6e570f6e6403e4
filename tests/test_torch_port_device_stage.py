"""The device stage `device/encode_fine` (`utils/profiler.py` device_stage,
`Profiler.device_times`, `DeviceTimes`; `runtime/codec.py` `_pipelined` and
`_collect`), on the CPU.

Outside a running `torch.profiler`, or on a CPU tensor, a device stage
does nothing and the codec counts no such stage. The card's events are
stood in for by a stub here (`FakeEvent`), so that the plumbing shows: a
pipeline's dispatch gathers each batch's event pairs and `_collect` adds
them, once that batch's results are in, one count a batch.
"""

import numpy as np
import pytest
import torch

from test_torch_port_spans import counts, frame, tiny_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.models import vqvae
from vqvdb_tpu_torch.runtime import codec as codec_mod
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.utils import profiler as profiler_mod
from vqvdb_tpu_torch.utils.profiler import DeviceTimes, Profiler, device_stage

CPU = torch.profiler.ProfilerActivity.CPU
MS = 2.5  # what FakeEvent.elapsed_time gives


class FakeEvent:
    """A stand-in for torch.cuda.Event: counts its records, and its elapsed
    time is read only once the batch it belongs to has been collected."""

    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = 0
        self.read = False
        FakeEvent.made.append(self)

    def record(self):
        self.recorded += 1

    def elapsed_time(self, end):
        assert self.recorded == end.recorded == 1
        self.read = end.read = True
        return MS


class OnCard:
    """A tensor's stand-in that claims to live on the card."""

    is_cuda = True


@pytest.fixture
def fake_card(monkeypatch):
    """`device_stage` as on the card: FakeEvents, and every tensor taken
    for one on the card."""
    FakeEvent.made = []
    monkeypatch.setattr(profiler_mod.torch.cuda, "Event", FakeEvent)
    real = profiler_mod.device_stage
    monkeypatch.setattr(vqvae, "device_stage", lambda name, like: real(name, OnCard()))
    return FakeEvent.made


def codec():
    tree, cfg = tiny_model()
    return VQCodec(tree, cfg, CodecConfig(batch_size=8, compute_dtype="float32"),
                   device="cpu")


def test_outside_a_gathered_dispatch_a_device_stage_does_nothing(fake_card):
    with torch.profiler.profile(activities=[CPU]):
        with profiler_mod.device_stage("device/encode_fine", OnCard()):
            pass
    p = Profiler()
    with p.device_times() as timed:  # no profiler records
        with profiler_mod.device_stage("device/encode_fine", OnCard()):
            pass
    assert timed is None
    with torch.profiler.profile(activities=[CPU]):
        with p.device_times() as timed:
            with device_stage("device/encode_fine", torch.ones(2)):  # a CPU tensor
                pass
    assert isinstance(timed, DeviceTimes) and timed.pairs == []
    assert fake_card == [] and p.report() == {}


@pytest.mark.parametrize("traced", [False, True])
def test_a_compress_on_the_cpu_counts_no_device_stage(tmp_path, traced):
    c = codec()
    c.profiler.reset()
    if traced:
        with torch.profiler.profile(activities=[CPU]):
            c.compress(frame(20, 1), tmp_path / "f.vqvdb")
    else:
        c.compress(frame(20, 1), tmp_path / "f.vqvdb")
    assert counts(c.profiler) == {"host/stage_in": 3, "host/pad": 1, "device/dispatch": 3,
                                  "device/readback_wait": 3}


def test_untraced_a_card_batch_records_no_event(fake_card, tmp_path):
    c = codec()
    c.profiler.reset()
    c.compress(frame(20, 1), tmp_path / "f.vqvdb")
    assert fake_card == [] and "device/encode_fine" not in c.profiler.report()


def test_traced_each_batch_is_timed_once_and_read_when_collected(fake_card, tmp_path,
                                                                 monkeypatch):
    """20 leaves at batch 8: three batches, each one pair of events, each
    pair read by `_collect` of its own batch after its wait, never before."""
    collect = VQCodec._collect
    seen = []

    def watched(item):
        pairs = list(item[0].timed.pairs)
        assert len(pairs) == 1 and not any(e.read for _, a, b in pairs for e in (a, b))
        out = collect(item)
        assert all(a.read and b.read for _, a, b in pairs) and item[0].timed is None
        seen.append(pairs)
        return out

    monkeypatch.setattr(VQCodec, "_collect", staticmethod(watched))
    c = codec()
    c.profiler.reset()
    with torch.profiler.profile(activities=[CPU]):
        c.compress(frame(20, 1), tmp_path / "f.vqvdb")
    fine = c.profiler.report()["device/encode_fine"]
    assert fine["count"] == 3 == len(seen) and len(fake_card) == 6
    assert fine["total_s"] == pytest.approx(3 * MS / 1e3)
    assert fine["mean_ms"] == pytest.approx(MS)


def test_a_batch_whose_step_fails_leaves_no_thread_gathering(fake_card, monkeypatch):
    """The gathering closes with the dispatch even when a step raises, so a
    later device stage outside a dispatch records nothing."""
    c = codec()

    def broken(*a, **k):
        raise RuntimeError("step failed")

    monkeypatch.setattr(codec_mod, "fused_score_argmin", broken)
    leaves = np.zeros((8, 8, 8, 8, 1), np.float32)
    with torch.profiler.profile(activities=[CPU]):
        with pytest.raises(RuntimeError, match="step failed"):
            c.encode_leaves(leaves)
        with profiler_mod.device_stage("device/encode_fine", OnCard()):
            pass
    assert len(fake_card) == 2 and "device/encode_fine" not in c.profiler.report()
