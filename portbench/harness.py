"""One run of one cell: inputs from the seed, the codec, the warm-up, the
timed window, the output check and the result line.

The window drives one entry of `vqvdb_tpu_torch` for a traffic of kind
"frames" (`frames.py`), a closed loop of one caller cycling through the
sequence's frames and waiting for each:

  decode   `VQCodec.decompress(path)`: a frame's file -> a LeafGrid in
           host memory. The files are written in set-up by the reference's
           writer of the traffic's `format_version` (v3 or v4), with the
           frame's origins and indices drawn uniformly from the seed.
  encode   `VQCodec.compress(grid, path, format_version=...)`: a frame's
           host LeafGrid -> a file of the traffic's version, rewritten each
           frame.

Each call is timed whole on the host clock. The last output of each checked
frame (the longest frame and others drawn from the seed) is kept; after the
window the program's state is freed and `checks.py` compares those outputs
with the plain reference (`reference/`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import checks, frames, reference, tracing
from portbench.counts import flops
from portbench.reference import v3, v4, vqmodel

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vqvdb_tpu")
CONTAINERS = {3: v3, 4: v4}  # the reference's writer and reader of each version


@dataclasses.dataclass
class Cell:
    """One entry of the manifest's `workloads`, with its files read."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


@dataclasses.dataclass
class Record:
    """What a run measured; the per-layer metric readers (`metrics/*.py`)
    read it. `flops_per_leaf` is the plain model's count for the direction
    (`counts/flops.py`, the encoder's from the configuration's reference
    module)."""

    direction: str
    chips: int
    sizes: Dict
    value_bytes: int
    peaks: Optional[Dict]
    flops_per_leaf: int = 0
    frames: int = 0
    leaves: int = 0
    batches: int = 0
    window_s: float = 0.0
    host_seconds: Dict = dataclasses.field(default_factory=dict)
    stages: Dict = dataclasses.field(default_factory=dict)
    trace: Optional[Dict] = None
    bounds: Dict = dataclasses.field(default_factory=dict)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: Path = ROOT / "BENCHMARK.json", bench: Path = BENCH) -> Cell:
    """The cell `name` of the manifest, its configuration (the manifest's
    `file`, from the manifest's directory), its traffic and limits files
    (`bench`/traffic/<mix>.json, `bench`/limits/<cell>.json), and the
    metrics it reports."""
    m = _json(manifest)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {manifest}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = _json(Path(manifest).parent / configs[w["config"]]["file"])
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    names = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if (name in x["workloads"] if "workloads" in x else x["moves"] in names)]
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench / "limits" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, bench: Path = BENCH) -> Callable:
    """`read` of `bench`/metrics/<name>.py."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (`vqvdb_tpu_torch` is not `vqvdb_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def peaks_for(kind: str) -> Optional[Dict]:
    for key, row in _json(BENCH / "counts" / "peaks.json")["cards"].items():
        if key in kind:
            return row
    return None


def card_power() -> str:
    """The first card's power limit as nvidia-smi reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def say(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def make_codec(cell: Cell, device: torch.device):
    from vqvdb_tpu_torch.api import make_codec as program_codec
    from vqvdb_tpu_torch.parallel.mesh import make_mesh

    cfg = cell.config
    mesh = None
    if cfg.get("mesh"):
        mesh = make_mesh(cfg["mesh"]["cards"], device=device.type)
    return program_codec(str(ROOT / cfg["model"]), batch_size=cfg["codec"]["batch_size"],
                         compute_dtype=cfg["codec"]["compute_dtype"],
                         device=None if mesh is not None else device, mesh=mesh)


def checked_frames(traffic: Dict, seed: int) -> List[int]:
    """The longest frame and `checked_frames - 1` others drawn from the seed."""
    n = traffic["frames"]
    rest = random.Random(seed).sample(range(n - 1), traffic["checked_frames"] - 1)
    return sorted(rest) + [n - 1]


def read_frame(path: Path):
    """(origins, indices) of a one-grid frame file, by the reader of the
    version its header states."""
    with open(path, "rb") as f:
        version = f.read(6)[5]
    _, ((_, origins, indices),) = CONTAINERS[version].read(path)
    return origins, indices


class Inputs:
    """A run's inputs, made from the seed: the frames, and for decode their
    files in the traffic's version (with uniform indices: uint8 up to 256
    codes, as ever, a wider draw beyond), in a work directory under TMPDIR."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, work: Path):
        cfg, tr = cell.config, cell.traffic
        self.direction = tr["direction"]
        self.name = "density" if cfg["sizes"]["in_channels"] == 1 else "velocity"
        made = frames.make_frames(tr, cfg["sizes"]["in_channels"], seed, device,
                                  with_leaves=self.direction == "encode")
        self.origins = [f["origins"].cpu().numpy() for f in made]
        self.sizes = [o.shape[0] for o in self.origins]
        self.leaves: List[np.ndarray] = []
        self.paths: List[Path] = []
        if self.direction == "encode":
            self.leaves = [f["leaves"].cpu().numpy() for f in made]
            return
        gen = torch.Generator(device=device).manual_seed((seed * 2 + 1) % 2**63)
        k = cfg["sizes"]["num_embeddings"]
        write = CONTAINERS[tr["format_version"]].write
        for f, o in enumerate(self.origins):
            idx = torch.randint(0, k, (o.shape[0], 4, 4, 4), generator=gen, device=device,
                                dtype=torch.uint8 if k <= 256 else torch.int32).cpu().numpy()
            path = work / f"frame{f:02d}.vqvdb"
            write(path, self.name, o, idx if k <= 256 else idx.astype(np.uint16), k)
            self.paths.append(path)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float) -> Dict:
    """One run; returns the result line's dict (with "check" last). `t0` is
    the process's start on the perf_counter clock."""
    devices = [torch.device(device.type, i) for i in range(cell.chips)] \
        if device.type == "cuda" else [device]
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _run(cell, seed, seconds, trace, device, devices, work, t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, devices, work, t0) -> Dict:
    cfg, tr = cell.config, cell.traffic
    direction = tr["direction"]
    params, model_cfg = vqmodel.load(ROOT / cfg["model"])
    sizes = flops.sizes_from_params(params, model_cfg, cfg["reference"])
    if sizes != cfg["sizes"]:
        raise ValueError(f"{cfg['model']}'s shapes are not the sizes of configs/{cfg['name']}.json:"
                         f" the artifact's are {sizes}")
    inputs = Inputs(cell, seed, device, work)
    if device.type == "cuda":  # the field's buffers are the benchmark's, not the program's
        torch.cuda.empty_cache()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)

    codec = make_codec(cell, device)
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    grids = [LeafGrid(name=inputs.name, origins=o, leaves=l)
             for o, l in zip(inputs.origins, inputs.leaves)]
    watch = set(checked_frames(tr, seed))
    out_path = work / "out.vqvdb"

    def call(f: int):
        if direction == "decode":
            got, stats = codec.decompress(inputs.paths[f])
            return got[0], stats
        path = work / f"checked{f:02d}.vqvdb" if f in watch else out_path
        return path, codec.compress(grids[f], path, format_version=tr["format_version"])

    for f in range(len(inputs.sizes)):  # warm-up: every frame once
        call(f)
    _sync(devices)
    codec.profiler.reset()

    rec = Record(direction=direction, chips=cell.chips, sizes=sizes,
                 value_bytes=2 if cfg["codec"]["compute_dtype"] == "bfloat16" else 4,
                 peaks=peaks_for(torch.cuda.get_device_name(0)) if device.type == "cuda" else None,
                 flops_per_leaf=flops.flops_per_leaf(sizes, direction, cfg["reference"]))
    kept: Dict[int, object] = {}
    times: List[float] = []
    ends: List = []
    failed = 0
    bs = cfg["codec"]["batch_size"]
    tracer = tracing.Tracer(trace)
    span = f"{tracing.SPAN_PREFIX}{'decompress' if direction == 'decode' else 'compress'}"
    with tracer:
        start = time.perf_counter()
        setup_s = start - t0
        deadline = start + seconds
        with tracer.span(tracing.WINDOW):
            i = 0
            while True:
                f = i % len(inputs.sizes)
                i += 1
                t = time.perf_counter()
                try:
                    with tracer.span(span):
                        out, stats = call(f)
                except Exception:  # a frame that fails counts and the run goes on
                    failed += 1
                    say(f"frame {f} failed:\n{traceback.format_exc()}")
                    out, stats = None, {"host_seconds": {}}
                end = time.perf_counter()
                times.append(end - t)
                ends.append((end - start, inputs.sizes[f] if out is not None else 0))
                rec.frames += 1
                if out is not None:
                    rec.leaves += inputs.sizes[f]
                    rec.batches += math.ceil(inputs.sizes[f] / bs)
                    if f in watch:
                        kept[f] = out
                for k, v in stats["host_seconds"].items():
                    rec.host_seconds[k] = rec.host_seconds.get(k, 0.0) + v
                if end >= deadline:
                    break
        rec.window_s = time.perf_counter() - start
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)
    rec.stages = codec.profiler.report()
    if trace:
        rec.trace = tracer.summarize([d.index or 0 for d in devices])
    del codec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check(cell, inputs, kept, params, model_cfg, device)
    correct, rows = checks.judge(numbers, cell.limits)
    correct = correct and failed == 0 and len(kept) == len(watch)

    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "decode_leaves_per_s": rec.leaves / rec.window_s,
            "encode_leaves_per_s": rec.leaves / rec.window_s,
            "decode_frame_p95_ms": 1e3 * statistics.quantiles(times, n=100)[94]
            if len(times) >= 2 else 1e3 * times[0],
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": rec.frames, "failed": failed,
              "metrics": metrics, "device": device_info(device, devices, peak)}
    if trace:
        result["device"].update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        result["breakdown"] = {
            "device_ops": tracing.top(rec.trace["device_ops"]),
            "idle_gaps": tracing.top(rec.trace["idle_gaps"])}
        for pattern, by in rec.bounds.items():
            say(f"roofline of {pattern}: bound by {by}")
    say(f"cell {cell.name} seed {seed}: {rec.frames} frames, {rec.leaves} leaves, "
        f"{rec.batches} batches in {rec.window_s:.3f} s; set-up {setup_s:.3f} s; "
        f"leaves/s by quarter of the window {quarters(ends, rec.window_s)}")
    result["check"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    result["_rows"] = rows
    return result


def quarters(ends: List, window_s: float) -> List[float]:
    """Leaves/s of the frames that ended in each quarter of the window."""
    got = [0, 0, 0, 0]
    for t, n in ends:
        got[min(3, int(4 * t / window_s))] += n
    return [round(4 * g / window_s) for g in got]


def device_info(device: torch.device, devices, peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(devices),
            "memory_peak_bytes": int(peak)}


def reference_model(params, model_cfg, cfg: Dict, device, rounding: str = "float32"):
    """The cell's plain reference (reference/<config "reference">.py)."""
    return reference.module(cfg["reference"]).Model(params, model_cfg, device, rounding)


def check(cell: Cell, inputs: Inputs, kept: Dict, params, model_cfg, device) -> Dict[str, float]:
    """The comparison numbers of the kept outputs against the reference."""
    model = reference_model(params, model_cfg, cell.config, device)
    tally = checks.Tally(inputs.direction)
    for f, out in sorted(kept.items()):
        if inputs.direction == "decode":
            o, idx = read_frame(inputs.paths[f])
            checks.decode_frame(tally, model, o, idx, out.origins, out.leaves, device)
        else:
            o, idx = read_frame(out)
            checks.encode_frame(tally, model, inputs.leaves[f], inputs.origins[f], o, idx, device)
    return tally.numbers()

