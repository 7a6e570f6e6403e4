#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vqvdb_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--leaves 70000] [--profile DIR]

Phases, in this order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1.
  2. build: compile every CUDA kernel of the package from its sources.
  3. main path: the flagship `models/scalar.vqmodel` (packed scalar, K=256,
     D=128) at full width, default CodecConfig (bf16, batch 4096):
     compress a seeded smooth field of --leaves leaves to a v3 file and
     decompress it, with every kernel launch counter reset just before and
     read just after.
  4. kernels: each kernel against its plain PyTorch version at the codec's
     batch (4096 leaves = 262,144 latent rows), on the flagship model's own
     features; kernel, plain, bound and library-call times.
  5. unfused path: fuse_proj_quantize=False (the nearest-code kernel) in
     f32, counters reset around it; its indices must equal the fused f32
     path's except on near-ties.
  6. parity: 1,024 leaves through a `cuda` and a `cpu` codec in f32 (TF32
     off for cuDNN and cuBLAS).
Then one JSON line of kernel numbers, the nvidia-smi line, and last the
result line {"ok": true, "device": {...}}. --profile DIR also times one
steady encode and decode batch under torch.profiler and writes the profiler
tables and the nvcc/ptxas report to DIR; without it no file is written
outside a temporary directory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA-core f32: the kernels compute in f32 by spec
BATCH_ROWS = 4096 * 64
NEAR_TIE_REL = 1e-4  # best-vs-runner-up score gap, relative to |best|
PARITY_ATOL = 1e-4  # card vs CPU decoded leaves, f32 with TF32 off
MIN_PSNR_DB = 30.0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smooth_field(seed: int, n_leaves: int):
    """A LeafGrid of `n_leaves` leaves cut from a seeded sum of Gaussian
    blobs on a 512 x 512 x 288 grid, sparsified by LeafGrid.from_dense."""
    import numpy as np

    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    rng = np.random.default_rng(seed)
    shape = (512, 512, 288)
    axes = [np.arange(s, dtype=np.float32) for s in shape]
    dense = np.zeros(shape, np.float32)
    for _ in range(24):
        c = rng.uniform(0, shape)
        s = rng.uniform(18, 48)
        amp = rng.uniform(0.3, 1.0)
        g = [np.exp(-((a - ci) ** 2) / (2 * s * s)).astype(np.float32)
             for a, ci in zip(axes, c)]
        dense += amp * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
    np.clip(dense, 0.0, 1.0, out=dense)
    dense[dense < 0.02] = 0.0
    full = LeafGrid.from_dense("density", dense)
    if full.num_leaves < n_leaves:
        raise RuntimeError(f"field has {full.num_leaves} active leaves, "
                           f"fewer than the {n_leaves} asked for")
    return LeafGrid(name="density", origins=full.origins[:n_leaves],
                    leaves=full.leaves[:n_leaves])


def index_check(name, got, ref_scores):
    """Indices `got` [N] against the argmin of plain f32 scores [N, K]:
    equal except where the best and runner-up differ by < NEAR_TIE_REL.
    Returns (mismatches, near-tie rows, max score regret)."""
    import torch

    if got.numel() == 0:
        return 0, 0, 0.0
    ref = torch.argmin(ref_scores, dim=1)
    got = got.long()
    bad = got != ref
    two = torch.topk(ref_scores, 2, dim=1, largest=False).values
    gap = two[:, 1] - two[:, 0]
    ties = gap < NEAR_TIE_REL * two[:, 0].abs().clamp(min=1.0)
    off = int((bad & ~ties).sum())
    regret = (ref_scores.gather(1, got[:, None]) - two[:, :1]).abs().max().item()
    if off:
        raise AssertionError(f"{name}: {off} rows differ off near-ties")
    return int(bad.sum()), int(ties.sum()), regret


def kernel_phase(codec, grid):
    """Phase 4: each kernel against its plain version at main-path shapes."""
    import torch

    from vqvdb_tpu_torch.models.quantizer import dequantize, nearest_indices, nearest_scores
    from vqvdb_tpu_torch.models.vqvae import encoder_apply, encoder_features
    from vqvdb_tpu_torch.ops import quantize as q

    dev = codec.device
    leaves = torch.from_numpy(grid.leaves[:4096]).to(dev)
    enc = codec.params["encoder"]
    emb = codec.params["vq"]["embedding"]
    m, c = codec._score_mc
    rows = []
    with torch.inference_mode():
        h_bf16 = encoder_features(enc, leaves.to(torch.bfloat16), codec.mcfg).reshape(-1, 64)
        h_f32 = encoder_features(enc, leaves, codec.mcfg).reshape(-1, 64)
        z = encoder_apply(enc, leaves, codec.mcfg).reshape(-1, 128).float()
        if h_bf16.shape[0] != BATCH_ROWS:
            raise AssertionError(f"kernel phase wants {BATCH_ROWS} rows")

        # -- dequantize: u8 file indices, bf16 codebook (the decode step)
        cb = emb.to(torch.bfloat16)
        idx_u8 = q.fused_score_argmin(h_bf16, m, c).to(torch.uint8)
        got = q.fused_dequantize(idx_u8, cb)
        err = (got.float() - dequantize(idx_u8, cb).float()).abs().max().item()
        if not torch.equal(got, dequantize(idx_u8, cb)):
            raise AssertionError("dequantize: kernel rows differ from plain")
        idx_i32 = idx_u8.to(torch.int32)
        idx_i32[::9973] = 300  # out of range -> zero rows
        idx_i32[1::9973] = -1
        for cbx in (cb, emb):
            got = q.fused_dequantize(idx_i32, cbx)
            if not torch.equal(got, dequantize(idx_i32, cbx)):
                raise AssertionError(f"dequantize: int32/{cbx.dtype} differs from plain")
            if got[::9973].any() or got[1::9973].any():
                raise AssertionError("dequantize: out-of-range rows are not zero")
        nbytes = BATCH_ROWS * 1 + cb.numel() * 2 + BATCH_ROWS * 128 * 2
        idx_lib = idx_u8.to(torch.int32)
        rows.append(dict(
            name="dequantize", route="cuda",
            source="vqvdb_tpu_torch/csrc/dequantize.cu",
            replaces="vqvdb_tpu/ops/quantize.py:110",
            max_abs_err=err,
            ms=cuda_ms(lambda: q.fused_dequantize(idx_u8, cb)),
            plain_ms=cuda_ms(lambda: dequantize(idx_u8, cb)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=cuda_ms(lambda: cb.index_select(0, idx_lib)),
            check="bit-equal, u8 and int32 (out-of-range rows zero), bf16 and f32"))

        # -- score-argmin: h [N, 64] (f32 check, bf16 as the encode step runs)
        scores = h_f32 @ m + c
        mis, ties, regret = index_check("score_argmin", q.fused_score_argmin(h_f32, m, c), scores)
        scores_b = h_bf16.float() @ m + c
        mis_b, ties_b, regret_b = index_check(
            "score_argmin bf16", q.fused_score_argmin(h_bf16, m, c), scores_b)
        f, k = m.shape
        nbytes = BATCH_ROWS * f * 2 + m.numel() * 4 + k * 4 + BATCH_ROWS * 4
        flops = 2.0 * BATCH_ROWS * f * k
        rows.append(dict(
            name="score_argmin", route="cuda",
            source="vqvdb_tpu_torch/csrc/score_argmin.cu",
            replaces="vqvdb_tpu/ops/quantize.py:187",
            max_abs_err=max(regret, regret_b),
            ms=cuda_ms(lambda: q.fused_score_argmin(h_bf16, m, c)),
            plain_ms=cuda_ms(lambda: q.score_argmin_plain(h_bf16, m, c)),
            bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
            bound_by="operations" if flops / F32_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
            library_ms=cuda_ms(lambda: torch.addmm(c, h_bf16.float(), m).argmin(1)),
            check=f"f32: {mis} mismatches / {ties} near-tie rows; "
                  f"bf16: {mis_b} / {ties_b}"))

        # -- nearest: z [N, 128] f32 against the codebook
        scores = nearest_scores(z, emb)
        mis, ties, regret = index_check("nearest_indices", q.fused_nearest_indices(z, emb), scores)
        esq = (emb * emb).sum(1)
        mt = -2.0 * emb.T
        d = z.shape[1]
        nbytes = BATCH_ROWS * d * 4 + emb.numel() * 4 + BATCH_ROWS * 4
        flops = 2.0 * BATCH_ROWS * d * emb.shape[0]
        rows.append(dict(
            name="nearest_indices", route="cuda",
            source="vqvdb_tpu_torch/csrc/score_argmin.cu",
            replaces="vqvdb_tpu/ops/quantize.py:41",
            max_abs_err=regret,
            ms=cuda_ms(lambda: q.fused_nearest_indices(z, emb)),
            plain_ms=cuda_ms(lambda: nearest_indices(z, emb)),
            bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
            bound_by="operations" if flops / F32_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
            library_ms=cuda_ms(lambda: torch.addmm(esq, z, mt).argmin(1)),
            check=f"f32: {mis} mismatches / {ties} near-tie rows"))
    return rows


def reset_launches():
    from vqvdb_tpu_torch.ops import quantize as q

    for fn in (q.fused_dequantize, q.fused_score_argmin, q.fused_nearest_indices):
        fn.launches = 0


def read_launches():
    from vqvdb_tpu_torch.ops import quantize as q

    return {"dequantize": q.fused_dequantize.launches,
            "score_argmin": q.fused_score_argmin.launches,
            "nearest_indices": q.fused_nearest_indices.launches}


def main_path(tree, cfg, grid, workdir: Path):
    """Phase 3: the default codec's compress -> v3 -> decompress."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.vdb.grid import psnr

    codec = VQCodec(tree, cfg, CodecConfig(), device="cuda")
    codec.compress(grid_subset(grid, 5000), workdir / "warm.vqvdb")
    codec.decompress(workdir / "warm.vqvdb")
    torch.cuda.synchronize()

    path = workdir / "main.vqvdb"
    reset_launches()
    cstats = codec.compress(grid, path)
    dgrids, dstats = codec.decompress(path)
    launches = read_launches()
    batches = -(-grid.num_leaves // codec.ccfg.batch_size)
    if launches["score_argmin"] != batches or launches["dequantize"] != batches:
        raise AssertionError(f"main path launches {launches}, expected {batches} "
                             "score_argmin and dequantize launches")
    out = dgrids[0]
    if out.leaves.shape != grid.leaves.shape or not np.isfinite(out.leaves).all():
        raise AssertionError("decoded leaves are not finite / of the input's shape")
    if not np.array_equal(out.origins, grid.origins):
        raise AssertionError("decoded origins differ from the input's")
    quality = psnr(out.leaves, grid.leaves)
    if not quality > MIN_PSNR_DB:
        raise AssertionError(f"round-trip PSNR {quality:.2f} dB <= {MIN_PSNR_DB}")
    raw_bytes = grid.leaves.nbytes
    result = {
        "leaves": grid.num_leaves, "batches": batches,
        "compress_leaves_per_s": cstats["leaves_per_sec"],
        "decompress_leaves_per_s": dstats["leaves_per_sec"],
        "compress_s": cstats["seconds"], "decompress_s": dstats["seconds"],
        "file_bytes": cstats["bytes"], "raw_leaf_bytes": raw_bytes,
        "ratio": raw_bytes / cstats["bytes"], "psnr_db": quality,
        "launches": launches,
    }
    return codec, result


def unfused_path(tree, cfg, grid, workdir: Path):
    """Phase 5: fuse_proj_quantize=False (nearest-code kernel) in f32,
    against the fused f32 path on the same leaves."""
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
    from vqvdb_tpu_torch.models.vqvae import encoder_features
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    fused = VQCodec(tree, cfg, CodecConfig(compute_dtype="float32"), device="cuda")
    unfused = VQCodec(tree, cfg, CodecConfig(compute_dtype="float32",
                                             fuse_proj_quantize=False), device="cuda")
    fused.compress(grid, workdir / "fused.vqvdb")
    reset_launches()
    stats = unfused.compress(grid, workdir / "unfused.vqvdb")
    launches = read_launches()
    if launches["nearest_indices"] < 1 or launches["score_argmin"]:
        raise AssertionError(f"unfused path launches {launches}")
    result = {"leaves": grid.num_leaves, "launches": launches,
              "compress_leaves_per_s": stats["leaves_per_sec"]}
    idx = {}
    for name in ("fused", "unfused"):
        with VqvdbReader(workdir / f"{name}.vqvdb") as r:
            idx[name] = torch.from_numpy(r.read_grid()[1].astype("int64")).reshape(-1)
    # Near-ties are judged on the fused f32 scores of the differing rows.
    bad = (idx["fused"] != idx["unfused"]).nonzero().reshape(-1)
    leaf_rows = torch.unique(bad // 64)
    with torch.inference_mode():
        leaves = torch.from_numpy(grid.leaves[leaf_rows.numpy()]).cuda()
        h = encoder_features(fused.params["encoder"], leaves, cfg).reshape(-1, 64)
        m, c = fused._score_mc
        scores = h @ m + c
    sel = (leaf_rows[:, None] * 64 + torch.arange(64)).reshape(-1)
    got = idx["unfused"][sel].cuda()
    mis, ties, regret = index_check("unfused vs fused", got, scores)
    result.update(mismatches=mis, near_tie_rows_checked=ties, max_regret=regret)
    return result


def parity_phase(tree, cfg, grid):
    """Phase 6: the same 1,024 leaves through a cuda and a cpu codec, f32."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.models.vqvae import encoder_features
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    ccfg = CodecConfig(batch_size=1024, compute_dtype="float32")
    leaves = grid.leaves[:1024]
    cpu = VQCodec(tree, cfg, ccfg, device="cpu")
    gpu = VQCodec(tree, cfg, ccfg, device="cuda")
    idx_cpu, idx_gpu = cpu.encode_leaves(leaves), gpu.encode_leaves(leaves)
    with torch.inference_mode():
        h = encoder_features(cpu.params["encoder"], torch.from_numpy(leaves), cfg)
        m, c = cpu._score_mc
        scores = h.reshape(-1, 64) @ m + c
    mis, ties, regret = index_check(
        "card vs cpu", torch.from_numpy(idx_gpu.astype(np.int64)).reshape(-1), scores)
    rec_cpu, rec_gpu = cpu.decode_indices(idx_cpu), gpu.decode_indices(idx_cpu)
    err = float(np.abs(rec_cpu - rec_gpu).max())
    if not err <= PARITY_ATOL:
        raise AssertionError(f"card vs cpu leaves differ by {err} > {PARITY_ATOL}")
    return {"leaves": len(leaves), "index_mismatches": mis, "near_tie_rows": ties,
            "max_regret": regret, "leaf_max_abs_err": err, "atol": PARITY_ATOL}


def profile_batches(codec, grid, out_dir: Path):
    """--profile: torch.profiler over one steady encode and decode batch;
    the tables go to `out_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    bs = codec.ccfg.batch_size
    leaves = torch.from_numpy(grid.leaves[:bs]).cuda()
    idx = codec._encode_step(leaves)
    codec._decode_step(idx)
    torch.cuda.synchronize()
    summary = {}
    for name, fn, arg in (("encode", codec._encode_step, leaves),
                          ("decode", codec._decode_step, idx)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(arg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=25)
        (out_dir / f"profile_{name}.txt").write_text(table)
        # Kernels run on one stream, so their durations add up to busy time.
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        summary[name] = {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
                         "idle_share": max(0.0, 1 - dev_us / 1e3 / (wall * 1e3))}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--leaves", type=int, default=70000)
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.ops import build

    t_start = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[build] {len(reports)} kernel libraries built in {time.perf_counter() - t0:.1f} s")
    if args.profile is not None:
        args.profile.mkdir(parents=True, exist_ok=True)
        (args.profile / "ptxas.txt").write_text(
            "\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line:
                log(f"[build] {name}: {line.strip()}")

    tree, cfg = load_model(REPO / "models" / "scalar.vqmodel")
    t0 = time.perf_counter()
    grid = smooth_field(args.seed, args.leaves)
    log(f"[data] {grid.num_leaves} leaves ({grid.leaves.nbytes / 2**20:.0f} MiB f32) "
        f"from seed {args.seed} in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        codec, main_res = main_path(tree, cfg, grid, workdir)
        log(f"[main] {json.dumps(main_res)}")
        kernels = kernel_phase(codec, grid)
        for row in kernels:
            log(f"[kernel] {row['name']}: {row.pop('check')}; ms {row['ms']:.4f} "
                f"plain {row['plain_ms']:.4f} bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}) library {row['library_ms']:.4f}")
        if args.profile is not None:
            log(f"[profile] {json.dumps(profile_batches(codec, grid, args.profile))}")
        torch.backends.cudnn.allow_tf32 = False
        unf = unfused_path(tree, cfg, grid_subset(grid, 16384 + 777), workdir)
        log(f"[unfused] {json.dumps(unf)}")
    par = parity_phase(tree, cfg, grid)
    log(f"[parity] {json.dumps(par)}")

    launches = dict(main_res["launches"])
    launches["nearest_indices"] = unf["launches"]["nearest_indices"]
    for row in kernels:
        row["launches"] = launches[row["name"]]
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} was not launched on its path")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def grid_subset(grid, n):
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    return LeafGrid(name=grid.name, origins=grid.origins[:n], leaves=grid.leaves[:n])


if __name__ == "__main__":
    sys.exit(main())
