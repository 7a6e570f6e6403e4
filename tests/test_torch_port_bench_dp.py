"""The port's data-parallel bench (`vqvdb_tpu_torch/bench_dp.py`, `python -m
vqvdb_tpu_torch.bench --data-parallel`) against the JAX package's
`benchmarks/bench_dp.py` and `bench.py --data-parallel`, on the CPU in f32.

Both harnesses run at batch 64 over 512 leaves, with no mesh and on meshes
of 2 and 8 (the port's CPU meshes of n entries; JAX's virtual CPU devices
of `tests/conftest.py`). Their weights differ (each package's own
initialiser), so the rows are held to the same keys and structure, not the
same rates: equal `n_devices`, `mesh`, `batch_size` and `leaves`, every
rate and time finite and > 0, each host-bound ceiling equal to `batch /
(shard + gather)` of its own row to the rounding. The port's per-shard
gather (the codec's `_read_back` and `_collect`) must give the full
gather's bits, and the bench file's bytes and decoded leaves must not depend
on the mesh.
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vqvdb_tpu_torch import bench, bench_dp
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.parallel.distributed import init_multi_host
from vqvdb_tpu_torch.parallel.mesh import make_mesh
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.utils.errors import ConfigError

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BATCH = 64
LEAVES = 512
MESHES = (0, 2, 8)  # the sizes both harnesses run
CEILINGS = {"host_bound_ceiling_leaves_per_sec": "host_gather_ms_per_batch",
            "host_bound_ceiling_shards_leaves_per_sec": "host_gather_shards_ms_per_batch"}
TINY = dict(batch=8, decode_steps=2, encode_steps=2, baseline_steps=2, baseline_batch=8,
            dp_leaves=LEAVES)


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX harness's rows, imported as `bench.py` imports it."""
    sys.path.insert(0, str(REPO))
    from benchmarks.bench_dp import bench_mesh_size

    return {n: bench_mesh_size(n, BATCH, LEAVES, "float32") for n in MESHES}


@pytest.fixture(scope="module")
def port_rows():
    """n -> (the port's row, its record), with no mesh and on CPU meshes."""
    out = {}
    for n in (0, 1) + MESHES[1:]:
        rec = {}
        out[n] = bench_dp.bench_mesh_size(n, BATCH, LEAVES, "float32", "cpu", record=rec), rec
    return out


def _dp_keys_of_bench_py():
    """The keys `bench.py --data-parallel` adds to its line, read from its
    source: the `out[...]` assignments and the key tuple of its loop."""
    tree = ast.parse((REPO / "bench.py").read_text())
    block = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                 and isinstance(n.test, ast.Name) and n.test.id == "data_parallel")
    keys = []
    for node in ast.walk(block):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == "out" and isinstance(t.slice, ast.Constant)):
                    keys.append(t.slice.value)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            keys += [e.value for e in node.iter.elts]
    return tuple(keys)


def _check_row(row):
    """Rates and times finite and > 0; each ceiling batch / (shard + gather)
    of the row's own rounded milliseconds, within their rounding."""
    for key, v in row.items():
        if key.endswith(("_per_sec", "_per_batch")):
            assert isinstance(v, float) and math.isfinite(v) and v > 0, (key, v)
    for ceiling, gather in CEILINGS.items():
        if ceiling not in row:
            continue
        ms = row["host_shard_ms_per_batch"] + row[gather]
        hi = row["batch_size"] / (max(ms - 1e-3, 1e-9) * 1e-3) + 0.05
        lo = row["batch_size"] / ((ms + 1e-3) * 1e-3) - 0.05
        assert lo <= row[ceiling] <= hi, (ceiling, row)


@pytest.mark.parametrize("n", MESHES)
def test_rows_have_the_jax_harness_keys_and_structure(jax_rows, port_rows, n):
    want, (got, _) = jax_rows[n], port_rows[n]
    assert list(got) == list(want)
    for key in ("n_devices", "mesh", "batch_size", "leaves"):
        assert got[key] == want[key], key
    assert got["n_devices"] == max(n, 1) and got["leaves"] == LEAVES
    _check_row(got)
    _check_row(want)


@pytest.mark.parametrize("entries", [1, 2, 8])
def test_per_shard_gather_is_the_full_gather(monkeypatch, entries):
    """host_stage_times holds the codec's per-shard gather to the full
    gather bit for bit, and raises when a shard's copy is wrong."""
    mesh = make_mesh(entries, "cpu")
    cfg = ModelConfig()
    codec = VQCodec(bench.untrained_params(cfg), cfg,
                    CodecConfig(batch_size=BATCH, compute_dtype="float32"), mesh=mesh)
    times = bench_dp.host_stage_times(codec, mesh, BATCH, cfg.num_embeddings, n_rep=2)
    assert len(times) == 4 and all(math.isfinite(t) and t > 0 for t in times)

    read_back = VQCodec._read_back

    def off_by_one(slot, results):
        read_back(slot, [r + 1 for r in results])

    monkeypatch.setattr(VQCodec, "_read_back", staticmethod(off_by_one))
    with pytest.raises(AssertionError, match="per-shard gather"):
        bench_dp.host_stage_times(codec, mesh, BATCH, cfg.num_embeddings, n_rep=1)


def test_bench_file_and_leaves_do_not_depend_on_the_mesh(port_rows):
    _, ref = port_rows[0]
    assert ref["leaves"].shape == (LEAVES, 8, 8, 8, 1)
    assert np.isfinite(ref["leaves"]).all()
    for n, (_, rec) in port_rows.items():
        assert rec["file"] == ref["file"], n
        assert rec["leaves"].tobytes() == ref["leaves"].tobytes(), n


def test_run_data_parallel_adds_bench_py_keys(capsys, monkeypatch):
    """run(data_parallel=True) (here through the module's entry point, as
    `python -m vqvdb_tpu_torch.bench --data-parallel --device cpu`) adds
    exactly `bench.py`'s eight keys, in its order; without it, none."""
    keys = _dp_keys_of_bench_py()
    assert len(keys) == 8 and keys == bench.DP_KEYS
    plain = bench.run("cpu", **TINY)
    assert not set(keys) & set(plain)
    dp = bench.run("cpu", data_parallel=True, **TINY)
    assert [k for k in dp if k not in plain] == list(keys)
    assert dp["mesh_devices"] == 1
    _check_row({"batch_size": TINY["batch"], **{k: dp[k] for k in keys[1:]}})
    monkeypatch.setattr(bench, "OFF_CARD", dataclasses.replace(bench.OFF_CARD, **TINY))
    bench._cli(["--data-parallel", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == list(dp) and line["device"] == "cpu"


def test_bench_dp_module_prints_and_writes_its_document(tmp_path):
    out = tmp_path / "dp.json"
    proc = subprocess.run(
        [sys.executable, "-m", "vqvdb_tpu_torch.bench_dp", "--device", "cpu", "--leaves",
         str(LEAVES), "--batch-size", str(BATCH), "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc == json.loads(out.read_text())
    assert list(doc) == ["platform", "device", "devices_available", "batch_size", "leaves",
                         "rows"]
    assert doc["platform"] == "cpu" and doc["device"] == "cpu"
    assert doc["devices_available"] == 1 and doc["leaves"] == LEAVES
    assert [(r["n_devices"], r["mesh"]) for r in doc["rows"]] == [(1, False), (1, True)]
    for row in doc["rows"]:
        assert row["batch_size"] == BATCH and row["leaves"] == LEAVES
        _check_row(row)


def test_bench_mesh_size_refuses_a_process_group(tmp_path):
    import torch.distributed as dist

    init_multi_host(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        assert dist.is_initialized()
        with pytest.raises(ConfigError, match="one process"):
            bench_dp.bench_mesh_size(0, BATCH, LEAVES, "float32", "cpu")
    finally:
        dist.destroy_process_group()
