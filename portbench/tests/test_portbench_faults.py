"""The output check fails a run whose timed path is broken underneath.

Each test skips the harness's look for a card and drives the rest of a run
(inputs from the seed, the codec, the window, the check) at a tiny size on
the CPU, with the cell's own limits, and plants one fault in the program:

  stale       a step whose results never reach the host: the second batch
              of each frame hands back what its buffer held before (its
              state unchanged)
  half        half of each batch left out: its rows come back as zeros
  exchange    on a mesh, the rows of every device but the first never
              copied back (the exchange between cards left out): a shard
              other than the first skips its readback, into the caller's
              grid or into its slot
  altered     one answer altered where it is produced: a leaf's decoded
              values flipped, or a leaf's codes moved by half the codebook
"""

import pytest
import torch

from portbench.tests.conftest import run_tiny, tiny_cell
from vqvdb_tpu_torch.runtime.codec import VQCodec

DECODE = "scalar.decode_frames"
ENCODE = "scalar.encode_frames"


def _stale(monkeypatch):
    """The second pipeline stage's results never reach the host: its buffer
    keeps what it held (the second batch of every frame of two or more)."""
    orig, seen = VQCodec._read_back, {}

    def read_back(slot, results):
        if seen.setdefault(id(slot), len(seen)) % 2 == 0:
            orig(slot, results)
        elif slot.done is not None:
            slot.done.record()
    monkeypatch.setattr(VQCodec, "_read_back", staticmethod(read_back))


def _half(monkeypatch):
    for name in ("_decode_step", "_encode_step"):
        orig = getattr(VQCodec, name)

        def step(self, x, orig=orig):
            out = orig(self, x).clone()
            out[out.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(VQCodec, name, step)


def _exchange(monkeypatch):
    """Every stage's slots but the first (the other devices' shards) are
    marked, and a marked slot's readback copies nothing: its rows keep what
    their memory held."""
    slots_for, read_back = VQCodec._slots_for, VQCodec._read_back

    def marked(self, kind):
        stages = slots_for(self, kind)
        for stage in stages:
            for slot in stage.slots[1:]:
                slot.skip_read_back = True
        return stages

    def skipping(slot, results):
        if not getattr(slot, "skip_read_back", False):
            read_back(slot, results)
        elif slot.done is not None:
            slot.done.record()
    monkeypatch.setattr(VQCodec, "_slots_for", marked)
    monkeypatch.setattr(VQCodec, "_read_back", staticmethod(skipping))


def _altered(monkeypatch):
    dec, enc = VQCodec._decode_step, VQCodec._encode_step

    def decode_step(self, x):
        out = dec(self, x).clone()
        out[0] = (1.0 - out[0]) if out.shape[-1] == 1 else -out[0]
        return out

    def encode_step(self, x):
        out = enc(self, x).clone()
        out[0] = ((out[0].to(torch.int32) + self.mcfg.num_embeddings // 2)
                  % self.mcfg.num_embeddings).to(out.dtype)
        return out
    monkeypatch.setattr(VQCodec, "_decode_step", decode_step)
    monkeypatch.setattr(VQCodec, "_encode_step", encode_step)


FAULTS = {"stale": _stale, "half": _half, "exchange": _exchange, "altered": _altered}


@pytest.mark.parametrize("cell,mesh", [(DECODE, 0), (ENCODE, 0), ("vec3.decode_frames", 0),
                                       (DECODE, 4)])
def test_a_sound_run_is_correct(cell, mesh):
    # vec3's bf16 decode is slow on the CPU: a longer window so that it
    # reaches every checked frame
    result = run_tiny(tiny_cell(cell, mesh), seconds=3.0 if cell.startswith("vec3") else 0.5)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell,fault,mesh", [
    (DECODE, "stale", 0), (DECODE, "half", 0), (DECODE, "altered", 0),
    (ENCODE, "stale", 0), (ENCODE, "half", 0), (ENCODE, "altered", 0), (DECODE, "exchange", 4)])
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell, fault, mesh):
    FAULTS[fault](monkeypatch)
    result = run_tiny(tiny_cell(cell, mesh))
    assert not result["correct"], result["check"]
