"""The codec's stage timers and trace ranges (`vqvdb_tpu_torch.utils.profiler`,
`runtime/codec.py`), on the CPU.

A stage and a span open a trace range under any running `torch.profiler`;
outside one a stage still counts and a span does nothing. The codec times
its stages once per batch (and `init/*` once per construction).

A trace's reader (`portbench/tracing.py`) charges a moment to the innermost
CPU event holding it, looking back at most LOOKBACK events from it; a range
opened farther back is not found. So every torch op and runtime call of a
codec call must lie within a bounded number of events of the opening of the
innermost program range that holds it (`lookback_distances`). Here that is
held to LOOKBACK // 2 at 64-leaf batches, whose convs and products run in
four row blocks as a 4,096-leaf batch's do on the card, which adds a runtime
event per launch (its twin in `test_torch_port_cuda.py` holds the card to
LOOKBACK). The file imports no JAX, so the card's tests can import from it.
"""

import re
import time
from pathlib import Path
from typing import Dict

import numpy as np
import pytest
import torch

from portbench.tracing import LOOKBACK
from vqvdb_tpu_torch import api
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_to_jax
from vqvdb_tpu_torch.models.vqvae import init_vqvae_params
from vqvdb_tpu_torch.parallel.mesh import make_mesh
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.utils import profiler as profiler_mod
from vqvdb_tpu_torch.utils.profiler import Profiler, span
from vqvdb_tpu_torch.vdb.grid import LeafGrid

MODELS = Path(__file__).resolve().parent.parent / "models"
# The names of the program's ranges (stages and spans).
PROGRAM = re.compile(r"(init|host|device|decode|encode|rb)/")
CPU = torch.profiler.ProfilerActivity.CPU


def lookback_distances(events) -> Dict[str, int]:
    """By program range: the most events that opened from its opening up to
    a torch op or runtime call it is the innermost program range of. The
    events are the CPU events of a trace (kineto events), indexed in the
    order `portbench.tracing` sorts them."""
    cpu = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in events if e.device_type() != torch.autograd.DeviceType.CUDA)
    worst: Dict[str, int] = {}
    holding = []  # (index, end, name) of the program ranges open at the sweep
    for i in sorted(range(len(cpu)), key=lambda i: (cpu[i][0], -cpu[i][1])):
        _, end, name = cpu[i]
        while holding and holding[-1][1] < end:
            holding.pop()
        if PROGRAM.match(name):
            holding.append((i, end, name))
        elif holding:
            j, _, rng = holding[-1]
            worst[rng] = max(worst.get(rng, 0), i - j)
    return worst


def frame(n: int, channels: int, seed: int = 0) -> LeafGrid:
    rng = np.random.default_rng(seed)
    origins = np.stack([np.arange(n) * 8, np.zeros(n), np.zeros(n)], 1).astype(np.int32)
    return LeafGrid(name="density", origins=origins,
                    leaves=rng.random((n, 8, 8, 8, channels), np.float32))


def traced_call(codec, direction: str, grid: LeafGrid, path, activities=(CPU,)):
    """(the names of the program ranges, lookback_distances) of one
    compress or decompress of `grid` traced with `activities`, after a
    warm-up call."""

    def call():
        if direction == "compress":
            codec.compress(grid, path)
        else:
            codec.decompress(path)

    codec.compress(grid, path)
    call()
    with torch.profiler.profile(activities=list(activities)) as prof:
        call()
    events = prof.profiler.kineto_results.events()
    return {e.name() for e in events if PROGRAM.match(e.name())}, lookback_distances(events)


# -- the gate -------------------------------------------------------------

def test_a_stage_and_a_span_are_ranges_under_a_plain_profiler():
    p = Profiler()
    with torch.profiler.profile(activities=[CPU]) as prof:
        with p("host/stage_in"):
            with span("decode/tail"):
                torch.ones(4).sum()
    got = {e.name(): e for e in prof.profiler.kineto_results.events()}
    stage, part = got["host/stage_in"], got["decode/tail"]
    assert stage.start_ns() <= part.start_ns()
    assert part.start_ns() + part.duration_ns() <= stage.start_ns() + stage.duration_ns()
    assert p.report()["host/stage_in"]["count"] == 1


def test_outside_a_profiler_a_stage_counts_and_a_span_does_nothing(monkeypatch):
    opened, clock = [], []
    real = time.perf_counter
    monkeypatch.setattr(profiler_mod, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    monkeypatch.setattr(profiler_mod.time, "perf_counter",
                        lambda: clock.append(1) or real())
    with span("decode/tail"):
        torch.ones(4).sum()
    assert opened == [] and clock == []
    p = Profiler()
    with p("device/dispatch"):
        pass
    assert opened == [] and len(clock) == 2
    assert p.report()["device/dispatch"]["count"] == 1


def test_the_gate_closes_with_the_profiler():
    p = Profiler()
    with torch.profiler.profile(activities=[CPU]):
        pass
    with torch.profiler.profile(activities=[CPU]) as prof:
        with p("host/scatter"):
            pass
    with p("host/scatter"), span("decode/tail"):
        torch.ones(2).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("host/scatter") == 1 and "decode/tail" not in names
    assert p.report()["host/scatter"]["count"] == 2


# -- the stages a codec counts ---------------------------------------------

def tiny_model():
    """A small reference-arch model (D=32, K=64) from the port's seeded
    initialiser, as the JAX-layout tree and its config."""
    cfg = ModelConfig(embedding_dim=32, num_embeddings=64)
    return params_to_jax(init_vqvae_params(torch.Generator().manual_seed(0), cfg)), cfg


def counts(prof: Profiler) -> Dict[str, int]:
    return {k: v["count"] for k, v in prof.report().items()}


@pytest.mark.parametrize("mesh", [0, 2])
def test_construction_times_its_stages_once(mesh):
    tree, cfg = tiny_model()
    kw = {"mesh": make_mesh(mesh, device="cpu")} if mesh else {"device": "cpu"}
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=8, compute_dtype="float32"), **kw)
    want = {"init/weights": 1, "init/tail_fold": 1, "init/score_operand": 1,
            "init/down_fold": 1}
    if mesh:
        want["init/replicate"] = 1
    assert counts(codec.profiler) == want


def test_stage_counts_of_a_compress_and_a_decompress(tmp_path):
    """20 leaves at batch 8: three batches, the last padded; decompress's
    scatter once a batch and once to close the grid."""
    tree, cfg = tiny_model()
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=8, compute_dtype="float32"),
                    device="cpu")
    codec.profiler.reset()
    path = tmp_path / "f.vqvdb"
    codec.compress(frame(20, 1), path)
    per_batch = {"host/stage_in": 3, "host/pad": 1, "device/dispatch": 3,
                 "device/readback_wait": 3}
    assert counts(codec.profiler) == per_batch
    codec.profiler.reset()
    (grid,), _ = codec.decompress(path)
    assert grid.num_leaves == 20
    assert counts(codec.profiler) == dict(per_batch, **{"host/scatter": 4})


# -- the nesting guard ---------------------------------------------------------

@pytest.fixture(scope="module")
def codecs():
    made = {}

    def get(model):
        if model not in made:
            made[model] = api.make_codec(MODELS / f"{model}.vqmodel", batch_size=64,
                                         compute_dtype="float32", device="cpu")
        return made[model]

    return get


COMMON = {"host/file", "host/stage_in", "host/pad", "device/dispatch", "rb/conv1", "rb/conv2",
          "device/read_back", "device/readback_wait"}
PARTS = {"compress": COMMON | {"encode/features", "encode/stem", "encode/rb",
                               "encode/attention", "encode/score_argmin",
                               "host/write_frames"},
         "decompress": COMMON | {"host/read_frames", "decode/dequantize", "decode/stem",
                                 # the head; on the CPU its plain version, whose two
                                 # halves are ranges of their own
                                 "decode/head", "decode/attention", "decode/tail",
                                 "host/scatter"}}


@pytest.mark.parametrize("model,direction", [("scalar", "compress"), ("scalar", "decompress"),
                                             ("vec3", "compress"), ("vec3", "decompress")])
def test_every_event_of_a_call_is_near_its_program_range(codecs, tmp_path, model, direction):
    codec = codecs(model)
    grid = frame(150, codec.mcfg.in_channels)  # two full batches and a ragged one
    names, worst = traced_call(codec, direction, grid, tmp_path / "f.vqvdb")
    trunk = {"decompress": {"scalar": {"decode/rb"}, "vec3": {"decode/rb1", "decode/rb2"}},
             "compress": {"scalar": set(), "vec3": set()}}[direction][model]
    assert names == PARTS[direction] | trunk
    assert max(worst.values()) < LOOKBACK // 2, worst
