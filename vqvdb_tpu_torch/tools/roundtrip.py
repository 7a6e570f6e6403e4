"""The port's file round trip, timed: a seeded field -> v3 -> leaves.

    python -m vqvdb_tpu_torch.tools.roundtrip [--model models/scalar.vqmodel]
        [--leaves 16384] [--seed 0] [--device cuda|cpu] [--batch-size 4096]
        [--compute-dtype bfloat16]

Compresses a seeded field (a sum of Gaussian blobs, sparsified) to a
temporary `.vqvdb` and decompresses it once as a warm-up (kernel builds,
allocations), then again timed, and prints one JSON line: the model,
device, leaves, batch size and dtype, the warm-up's seconds, compress and
decompress leaves/s, file bytes and ratio to f32, PSNR, and the codec's
`host_seconds`. These rates are the host's wall clock with file I/O
included and move between runs; the device program's rates are `python -m
vqvdb_tpu_torch.cli bench`'s.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

REPO_MODELS = Path(__file__).resolve().parent.parent.parent / "models"


def field(seed: int, n_leaves: int):
    """A LeafGrid of up to `n_leaves` leaves of a seeded sum of Gaussian
    blobs in [0, 1], sparsified at 0.02."""
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    rng = np.random.default_rng(seed)
    side = 8 * max(4, int(np.ceil((4 * n_leaves) ** (1 / 3))))
    shape = (side, side, side)
    axes = [np.arange(s, dtype=np.float32) for s in shape]
    dense = np.zeros(shape, np.float32)
    for _ in range(12):
        c = rng.uniform(0, side, 3)
        s = rng.uniform(side / 16, side / 6)
        g = [np.exp(-((a - ci) ** 2) / (2 * s * s)).astype(np.float32) for a, ci in zip(axes, c)]
        dense += rng.uniform(0.3, 1.0) * g[0][:, None, None] * g[1][None, :, None] * g[2]
    np.clip(dense, 0.0, 1.0, out=dense)
    dense[dense < 0.02] = 0.0
    full = LeafGrid.from_dense("density", dense)
    n = min(n_leaves, full.num_leaves)
    return LeafGrid("density", full.origins[:n], full.leaves[:n])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default=str(REPO_MODELS / "scalar.vqmodel"))
    ap.add_argument("--leaves", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--compute-dtype", default="bfloat16")
    args = ap.parse_args(argv)

    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.utils.compile_cache import enable_persistent_cache
    from vqvdb_tpu_torch.vdb.grid import psnr

    enable_persistent_cache()
    codec = api.make_codec(args.model, batch_size=args.batch_size,
                           compute_dtype=args.compute_dtype, device=args.device)
    grid = field(args.seed, args.leaves)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "roundtrip.vqvdb"
        t0 = time.perf_counter()
        codec.compress(grid, path)  # warm-up: kernel builds, allocations
        codec.decompress(path)
        warm = time.perf_counter() - t0
        cstats = codec.compress(grid, path)
        grids, dstats = codec.decompress(path)
    device = str(codec.device)
    if codec.device.type == "cuda":
        import torch

        device = torch.cuda.get_device_name(codec.device)
    out = {"model": str(args.model), "device": device, "leaves": grid.num_leaves,
           "batch_size": args.batch_size, "compute_dtype": args.compute_dtype,
           "warmup_seconds": warm,
           "compress_leaves_per_s": cstats["leaves_per_sec"],
           "decompress_leaves_per_s": dstats["leaves_per_sec"],
           "bytes": cstats["bytes"], "ratio": grid.leaves.nbytes / cstats["bytes"],
           "psnr_db": psnr(grids[0].leaves, grid.leaves),
           "host_seconds": {**cstats["host_seconds"], **dstats["host_seconds"]}}
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
