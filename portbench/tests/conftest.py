"""Shared pieces of the benchmark's tests: a cell of the manifest shrunk to
a size the CPU runs in seconds (every width as configured; fewer, smaller
frames on a smaller domain, 64-leaf batches), and a helper that runs it."""

import time
from pathlib import Path

import pytest
import torch

from portbench import harness

TINY_TRAFFIC = {"frames": 3, "first_leaves": 40, "step_leaves": 30, "domain": [64, 64, 48],
                "blobs": 6, "sigma": [4.0, 10.0], "checked_frames": 2}


def tiny_cell(name: str, mesh: int = 0, manifest: Path = harness.ROOT / "BENCHMARK.json",
              bench: Path = harness.BENCH) -> harness.Cell:
    """The cell `name` (of `manifest`, its files under `bench`) at a tiny
    size; with `mesh`, its codec on a mesh of that many CPU entries (the
    data-parallel path of several cards)."""
    cell = harness.load_cell(name, manifest, bench)
    if mesh:
        cell.config = dict(cell.config, mesh={"cards": mesh})
    cell.config = dict(cell.config, codec=dict(cell.config["codec"], batch_size=64))
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    cell.chips = 1
    return cell


def run_tiny(cell: harness.Cell, seed: int = 2**31 + 11, seconds: float = 0.5,
             trace: bool = False) -> dict:
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())


@pytest.fixture(autouse=True)
def _few_threads():
    """One process with few threads: the CPU's sums, and so the bf16 codec's
    indices, depend on the thread count."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
