"""Data-parallel codec benchmark: the mesh codec's end-to-end decode rate and
the host-side cost model of a data-parallel step (the counterpart of the
JAX package's `benchmarks/bench_dp.py`).

    python -m vqvdb_tpu_torch.bench_dp [--out F] [--batch-size 2048]
                                       [--leaves N] [--device cuda|cpu]

It runs the file-level codec with no mesh and on meshes of 1, 2, 4 ... of
the visible cards (`parallel/mesh.py`), and on each mesh times the host
stages that a data-parallel decode step adds or keeps serial: the scatter
of a batch of indices into the shards (`shard_batch`), the readback of the
whole result to one host array, the per-shard readback that the codec
really runs (`VQCodec._read_back` into each shard's pinned buffer, then
`VQCodec._collect`), and the fenced device step. However many cards share
the compute, these bound the aggregate rate:

    aggregate <= batch / (t_shard + t_gather)

Each mesh is one process's (the JAX harness is single-process too); under
an initialised torch.distributed group it raises ConfigError. Prints and
writes (`--out`) one JSON document: {platform, device, devices_available,
batch_size, leaves, rows}, a row per mesh with the JAX harness's keys.
On the card: 200,000 leaves in bf16; on the CPU (`--device cpu`, a mesh of
one entry): 6,144 in f32, as the JAX harness sizes itself off the TPU.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vqvdb_tpu_torch.bench import launches, untrained_params
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import DeviceLike, resolve_device
from vqvdb_tpu_torch.parallel.mesh import Mesh, make_mesh, make_sharded_decode, shard_batch
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.utils.errors import ConfigError
from vqvdb_tpu_torch.vdb.grid import LeafGrid

ONE_PROCESS = (
    "bench_dp measures a mesh of one process's devices, as the JAX harness "
    "does; run it outside an initialised torch.distributed process group")


def _median_s(fn, n_rep: int, before=None):
    """(median seconds of `fn()` over n_rep calls, each after an untimed
    `before()`; the last call's result)."""
    ts = []
    for _ in range(n_rep):
        if before is not None:
            before()
        t0 = time.perf_counter()
        got = fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), got


def _full_gather(outs: Sequence[torch.Tensor]) -> np.ndarray:
    """Every shard's rows read back into one host array (the counterpart of
    `np.asarray` of a sharded array)."""
    if len(outs) == 1:
        return outs[0].cpu().numpy()
    return torch.cat([o.cpu() for o in outs]).numpy()


def host_stage_times(codec: VQCodec, mesh: Mesh, batch_size: int, k: int,
                     n_rep: int = 30) -> Tuple[float, float, float, float]:
    """Median seconds a call of each host stage of a data-parallel decode
    step on `mesh`: (scatter in, full gather, per-shard gather, device step).
    The gathers run after the step is fenced; the per-shard gather must give
    the full gather's bits."""
    idx = np.random.default_rng(0).integers(0, k, (batch_size, 4, 4, 4)).astype(np.uint8)

    def scatter():
        shard_batch(idx, mesh)
        mesh.synchronize()

    t_shard, _ = _median_s(scatter, n_rep)

    step = make_sharded_decode(mesh, codec)
    dev_in = shard_batch(idx, mesh)
    outs: List[torch.Tensor] = []

    def run():
        outs[:] = step(dev_in)
        mesh.synchronize()

    run()  # warm
    t_gather, host = _median_s(lambda: _full_gather(outs), n_rep, run)

    # The codec's own path: each shard's output into its slot's host buffer
    # on its stream, then the shards' rows into the batch.
    stage = codec._slots_for("decode")[0]
    per = mesh.shard_rows(batch_size)
    live = [(j, slot, (mesh.first_shard + j) * per, per) for j, slot in enumerate(stage.slots)]

    def gather_shards():
        for j, (slot, y) in enumerate(zip(stage.slots, outs)):
            with mesh.stream(j):
                codec._read_back(slot, (y,))
        (rows,), _, _ = codec._collect((stage, live, None, batch_size))
        return rows

    t_gather_shards, rows = _median_s(gather_shards, n_rep, run)
    if rows.shape != host.shape or rows.tobytes() != host.tobytes():
        raise AssertionError("the per-shard gather differs from the full gather")
    t_step, _ = _median_s(run, n_rep)
    return t_shard, t_gather, t_gather_shards, t_step


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {name: after[name] - before[name] for name in after}


def bench_mesh_size(n_dev: int, batch_size: int, n_leaves: int, compute_dtype: str,
                    device: DeviceLike = None, mesh: Optional[Mesh] = None,
                    record: Optional[Dict] = None) -> Dict:
    """One row: `ModelConfig()` with untrained weights (the port's
    initialisers, seed 0) at `batch_size` and `compute_dtype`, with no mesh
    (n_dev 0), on `make_mesh(n_dev, device)`, or on `mesh` (of n_dev
    entries: a one-card mesh of several entries, or a CPU mesh). It
    compresses the JAX harness's grid (uniform leaves from default_rng(1),
    origins x = 8 i) into a temporary file, decodes one batch to warm up,
    and times a `decode_stream` pass; with a mesh it adds
    `host_stage_times` and the host-bound ceilings. `record`, if given,
    receives the file's bytes (`file`), its decompressed leaves (`leaves`)
    and the kernel launches of the compress and of the timed pass
    (`compress_launches`, `decode_launches`)."""
    if dist.is_available() and dist.is_initialized():
        raise ConfigError(ONE_PROCESS)
    if mesh is None and n_dev > 0:
        mesh = make_mesh(n_dev, device)
    if mesh is not None and mesh.size != n_dev:
        raise ValueError(f"a mesh of {mesh.size} entries given for n_dev={n_dev}")
    mcfg = ModelConfig()
    codec = VQCodec(untrained_params(mcfg), mcfg,
                    CodecConfig(batch_size=batch_size, compute_dtype=compute_dtype),
                    device=device, mesh=mesh)
    origins = np.zeros((n_leaves, 3), np.int32)
    origins[:, 0] = np.arange(n_leaves) * 8
    leaves = np.random.default_rng(1).random((n_leaves, 8, 8, 8, 1), np.float32)
    grid = LeafGrid(name="bench", origins=origins, leaves=leaves)

    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "bench.vqvdb"
        before = launches()
        codec.compress(grid, path)
        compressed = launches()
        warm = codec.decode_stream(path)
        next(warm)
        warm.close()
        started = launches()
        t0 = time.perf_counter()
        total = 0
        for _meta, batch, _orig in codec.decode_stream(path):
            total += batch.shape[0]
        dt = time.perf_counter() - t0
        if record is not None:
            record.update(compress_launches=_diff(compressed, before),
                          decode_launches=_diff(launches(), started),
                          file=path.read_bytes())
            (got,), _ = codec.decompress(path)
            record["leaves"] = got.leaves

    row = {
        "n_devices": n_dev if n_dev else 1,
        "mesh": mesh is not None,
        "batch_size": batch_size,
        "leaves": total,
        "e2e_decode_leaves_per_sec": round(total / dt, 1),
    }
    if mesh is not None:
        t_shard, t_gather, t_gather_shards, t_step = host_stage_times(
            codec, mesh, batch_size, mcfg.num_embeddings)
        row.update({
            "host_shard_ms_per_batch": round(t_shard * 1e3, 3),
            "host_gather_ms_per_batch": round(t_gather * 1e3, 3),
            "host_gather_shards_ms_per_batch": round(t_gather_shards * 1e3, 3),
            "device_step_ms_per_batch": round(t_step * 1e3, 3),
            # Host-bound ceilings if device compute were free: the full
            # readback against the per-shard copy the codec runs.
            "host_bound_ceiling_leaves_per_sec": round(
                batch_size / max(t_shard + t_gather, 1e-9), 1),
            "host_bound_ceiling_shards_leaves_per_sec": round(
                batch_size / max(t_shard + t_gather_shards, 1e-9), 1),
        })
    return row


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Rows for no mesh and meshes of 1, 2, 4 ... up to the visible cards
    (one entry on the CPU); prints the document and writes it to --out."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--leaves", type=int, default=0,
                    help="0 = auto: 200,000 on the card, 6,144 on the CPU")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    n_avail = torch.cuda.device_count() if on_card else 1
    n_leaves = args.leaves or (200_000 if on_card else 6_144)
    dtype = "bfloat16" if on_card else "float32"

    rows = [bench_mesh_size(0, args.batch_size, n_leaves, dtype, dev)]  # no mesh
    n = 1
    while n <= n_avail:
        rows.append(bench_mesh_size(n, args.batch_size, n_leaves, dtype, dev))
        n *= 2
    doc = {
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "devices_available": n_avail,
        "batch_size": args.batch_size,
        "leaves": n_leaves,
        "rows": rows,
    }
    text = json.dumps(doc, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return doc


if __name__ == "__main__":
    main()
