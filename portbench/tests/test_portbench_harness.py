"""The harness: cells, traffic, limits and metrics found by name; the
manifest's contract; the result line; the import check."""

import hashlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, host
from portbench.tests.conftest import run_tiny, tiny_cell

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = harness.load_cell(name)
    assert cell.traffic["kind"] == "frames" and cell.limits
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_the_manifest_keeps_the_contract():
    m = MANIFEST
    assert list(m) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert m["paths"] == ["portbench"] and m["command"][1].startswith("portbench/")
    assert 1 <= m["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in m["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= 1
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(p["unit"]) and p["better"] in ("lower", "higher")
        assert 1 <= len(p["layer"]) <= 200 and "\n" not in p["layer"]
        assert not p["name"].endswith("_roofline") or p["unit"] == "%"
    for f in BENCH.rglob("*"):
        if "__pycache__" not in f.parts:
            assert all(NAME.match(part) for part in f.relative_to(ROOT).parts), f


def test_a_cell_and_a_metric_can_be_added_as_files_alone(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "vec3.encode_frames", "config": "vec3",
                           "traffic": "frames-encode", "chips": 1, "why": "added by files alone"})
    m["end_to_end"][2]["workloads"].append("vec3.encode_frames")
    m["per_layer"].append({"name": "leaves_per_frame", "unit": "leaves", "better": "higher",
                           "source": "program_counter", "layer": "codec pipeline",
                           "moves": "encode_leaves_per_s", "workloads": ["vec3.encode_frames"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    shutil.copy(bench / "limits" / "scalar.encode_frames.json",
                bench / "limits" / "vec3.encode_frames.json")
    (bench / "metrics" / "leaves_per_frame.py").write_text(
        "def read(rec):\n    return rec.leaves / rec.frames if rec.frames else None\n")
    cell = harness.load_cell("vec3.encode_frames", tmp_path / "BENCHMARK.json", bench)
    assert cell.config["name"] == "vec3" and cell.traffic["direction"] == "encode"
    assert [p["name"] for p in cell.per_layer][-1] == "leaves_per_frame"
    rec = harness.Record(direction="encode", chips=1, sizes=cell.config["sizes"], value_bytes=2,
                         peaks=None, frames=4, leaves=100)
    assert harness.metric_reader("leaves_per_frame", bench)(rec) == 25.0


def _add_cells(tmp_path):
    """A copy of the benchmark under `tmp_path`, grown by new files and
    appended manifest entries alone, as a `model_config` change adds a cell:
    upstream's strided-conv encoder (`models/scalar_reference.vqmodel`) on
    `frames-encode`, and a K = 512 artifact drawn from a seed and written
    with the port's `save_model`, decoded and encoded on v4 traffic. Returns
    (manifest, bench dir); the copy's artifacts are under `tmp_path`/models."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.models.vqvae import init_vqvae_params

    from portbench.counts import flops
    from portbench.reference import vqmodel

    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "models").mkdir()
    shutil.copy(ROOT / "models" / "scalar_reference.vqmodel", tmp_path / "models")
    cfg = ModelConfig(in_channels=1, embedding_dim=128, num_embeddings=512, encoder_arch="packed")
    save_model(tmp_path / "models" / "scalar_k512.vqmodel",
               init_vqvae_params(torch.Generator().manual_seed(2**31 + 7), cfg), cfg)
    m = json.loads(json.dumps(MANIFEST))
    scalar = json.loads((BENCH / "configs" / "scalar.json").read_text())
    for name, model, ref in (("scalar_reference", "scalar_reference.vqmodel", "reference"),
                             ("scalar_k512", "scalar_k512.vqmodel", "packed")):
        params, model_cfg = vqmodel.load(tmp_path / "models" / model)
        config = dict(scalar, name=name, model=f"models/{model}", reference=ref,
                      sizes=flops.sizes_from_params(params, model_cfg, ref))
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
        m["configs"].append({"name": name, "source": scalar["source"],
                             "file": f"portbench/configs/{name}.json", "reduced": [],
                             "why": "added by files alone"})
    for direction in ("decode", "encode"):
        traffic = json.loads((BENCH / "traffic" / f"frames-{direction}.json").read_text())
        (bench / "traffic" / f"frames-{direction}-v4.json").write_text(
            json.dumps(dict(traffic, format_version=4)))
    cells = {"scalar_reference.encode_frames": ("scalar_reference", "frames-encode"),
             "scalar_k512.decode_frames": ("scalar_k512", "frames-decode-v4"),
             "scalar_k512.encode_frames": ("scalar_k512", "frames-encode-v4")}
    for name, (config, traffic) in cells.items():
        direction = name.split(".")[1].split("_")[0]
        m["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                               "why": "added by files alone"})
        for metric in m["end_to_end"] + m["per_layer"]:
            if f"scalar.{direction}_frames" in metric.get("workloads", []):
                metric["workloads"].append(name)
        shutil.copy(bench / "limits" / f"scalar.{direction}_frames.json",
                    bench / "limits" / f"{name}.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path / "BENCHMARK.json", bench


def _shift_the_files_codes(monkeypatch):
    """Each code the program writes to a frame file, or reads from one, moved
    to the next codeword (mod K)."""
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader, VqvdbWriter

    write, read = VqvdbWriter.write_batch, VqvdbReader.next_batch_residual

    def shifted(idx, k):
        return ((idx.astype(np.int64) + 1) % k).astype(idx.dtype)

    def write_batch(self, indices, origins, *rest):
        idx = np.asarray(indices)
        return write(self, shifted(idx, self._shared_num_embeddings), origins, *rest)

    def next_batch_residual(self, max_batch):
        idx, *rest = read(self, max_batch)
        return (shifted(idx, self.num_embeddings), *rest)
    monkeypatch.setattr(VqvdbWriter, "write_batch", write_batch)
    monkeypatch.setattr(VqvdbReader, "next_batch_residual", next_batch_residual)


@pytest.mark.parametrize("shift", [False, True], ids=["sound", "codes_shifted"])
@pytest.mark.parametrize("name", ["scalar_reference.encode_frames", "scalar_k512.decode_frames",
                                  "scalar_k512.encode_frames"])
def test_a_cell_added_as_files_alone_runs_whole(tmp_path, monkeypatch, name, shift):
    manifest, bench = _add_cells(tmp_path)
    cell = tiny_cell(name, manifest=manifest, bench=bench)
    assert cell.traffic["format_version"] == (4 if "k512" in name else 3)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    if shift:
        _shift_the_files_codes(monkeypatch)
    result = run_tiny(cell)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["correct"] is not shift, result["check"]


def test_decode_inputs_are_the_parents_bit_for_bit(tmp_path):
    # sha256 of the three frame files of the tiny flagship decode cell at this
    # seed, as the benchmark wrote them before v4 inputs existed
    inputs = harness.Inputs(tiny_cell("scalar.decode_frames"), 2**31 + 11, torch.device("cpu"),
                            tmp_path)
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in inputs.paths)).hexdigest()
    assert [p.stat().st_size for p in inputs.paths] == [3137, 5417, 7697]
    assert digest == "0c1eb1d42c9900b19a33af638badf01ea919c1c001a5c43597a9c29d996157e4"


def test_decode_inputs_beyond_256_codes_are_v4_with_u16_codes(tmp_path):
    manifest, bench = _add_cells(tmp_path)
    cell = tiny_cell("scalar_k512.decode_frames", manifest=manifest, bench=bench)
    inputs = harness.Inputs(cell, 2**31 + 11, torch.device("cpu"), tmp_path)
    for path in inputs.paths:
        assert path.read_bytes()[5] == 4
        _, idx = harness.read_frame(path)
        assert idx.dtype == np.uint16 and idx.max() < 512
    assert max(int(harness.read_frame(p)[1].max()) for p in inputs.paths) > 255


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contracts_keys(trace):
    result = run_tiny(tiny_cell("scalar.decode_frames"), trace=trace)
    result.pop("_rows")
    keys = KEYS[:-1] + (["breakdown"] if trace else []) + ["check"]
    assert list(result) == keys
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in result["device"] and "busy_s" in result["device"]
    else:
        assert set(result["metrics"]) == {"decode_leaves_per_s", "decode_frame_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    import vqvdb_tpu_torch  # noqa: F401  (begins with vqvdb_tpu, is not it)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vqvdb_tpu.core", types.ModuleType("vqvdb_tpu.core"))
    assert harness.forbidden_modules() == ["vqvdb_tpu"]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax", "vqvdb_tpu"]


def _run_module():
    spec = importlib.util.spec_from_file_location("portbench_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("loaded", [None, "jax", "vqvdb_tpu", "flax"])
def test_a_run_that_loads_jax_prints_no_result(monkeypatch, capsys, loaded):
    mod = _run_module()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(harness, "card_power", lambda: "700.00 W")
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "check": {}, "_rows": []}
    monkeypatch.setattr(harness, "run", lambda *a, **k: dict(line))
    if loaded:
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    rc = mod.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    if loaded:
        assert rc == 3 and out.out == "" and loaded in out.err
    else:
        assert rc == 0 and json.loads(out.out.splitlines()[-1])["correct"] is True


def test_without_a_card_the_run_exits_with_no_result():
    got = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert got.returncode == 2 and got.stdout == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path, monkeypatch):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(FileNotFoundError):
        run_tiny(tiny_cell("scalar.decode_frames"))


@pytest.mark.parametrize("form", ["split", "joined"])
def test_the_cpu_pool_takes_the_size_the_configuration_states(monkeypatch, form):
    for var in host.POOL_VARS:
        monkeypatch.delenv(var, raising=False)
    argv = (["--seed", "3", "--workload", CELLS[0]] if form == "split"
            else ["--workload=" + CELLS[0], "--seed", "3"])
    config = harness.load_cell(CELLS[0]).config
    assert config["cpu_threads"] == 1 and "cpu_threads" in config["assumed"]
    assert host.set_pool(argv) == 1
    assert all(host.os.environ[var] == "1" for var in host.POOL_VARS)


def test_a_configuration_without_a_pool_size_keeps_torchs_default(tmp_path, monkeypatch):
    for var in host.POOL_VARS:
        monkeypatch.delenv(var, raising=False)
    m = json.loads(json.dumps(MANIFEST))
    config = json.loads((ROOT / m["configs"][0]["file"]).read_text())
    config.pop("cpu_threads")
    (tmp_path / "c.json").write_text(json.dumps(config))
    m["configs"][0]["file"] = "c.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    name = next(w["name"] for w in m["workloads"] if w["config"] == m["configs"][0]["name"])
    assert host.cpu_threads(name, tmp_path / "BENCHMARK.json") is None
    assert host.cpu_threads("no.such_cell") is None
    assert host.set_pool(["--seed", "1"]) is None
    assert not any(var in host.os.environ for var in host.POOL_VARS)
