#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vqvdb_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--leaves 70000] [--side-leaves 17161]
                          [--profile DIR]

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
  5. reference-arch path: `models/scalar_reference.vqmodel` at full width on
     the same --leaves leaves, default CodecConfig: compress -> v3 ->
     decompress with the counters reset before and read after each half
     (one fused residual-block launch per encode batch), then the same
     compress with fuse_rb16=False (the eager block) in turns for an A/B.
  6. residual-VQ path (`models/scalar_rvq2.vqmodel`) and vec3 path
     (`models/vec3.vqmodel` on a seeded 3-channel field) at --side-leaves
     leaves each, counters around each half: two nearest-code and two
     dequantize launches per residual-VQ encode batch, two dequantize
     launches per decode batch.
  7. kernels of these paths: the fused residual block at [4096,8,8,8,16] in
     bf16 and f32 on the reference model's own features, and score-argmin at
     feature widths 32 (reference arch) and 128 (vec3).
  8. unfused path: fuse_proj_quantize=False (the nearest-code kernel) in
     f32, counters reset around it; its indices must equal the fused f32
     path's except on near-ties.
  9. parity: 1,024 leaves through a `cuda` and a `cpu` codec in f32 (TF32
     off for cuDNN and cuBLAS), for the flagship, the reference arch and
     the residual-VQ model. A residual-VQ row is compared stage by stage:
     a row that differs at a stage must be a near-tie of that stage's
     scores, and its later stages (which code another residual) are skipped.
Then one JSON line of kernel numbers, the nvidia-smi line, and last the
result line {"ok": true, "device": {...}}. --profile DIR also times one
steady encode and decode batch of the flagship and of the reference arch
under torch.profiler and writes the profiler tables and the nvcc/ptxas
report to DIR; without it no file is written outside a temporary directory.
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
MIN_PSNR_VEC3_DB = 25.0  # against peak 1.0 on a [-1, 1] field
RB_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # fused block vs plain, atol = rtol


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


def smooth_field(seed: int, n_leaves: int, channels: int = 1):
    """A LeafGrid of `n_leaves` leaves cut from a seeded sum of 24 Gaussian
    blobs, sparsified by LeafGrid.from_dense: a density in [0, 1] on a
    512 x 512 x 288 grid, or for 3 channels a vector field in [-1, 1] on a
    384 x 384 x 192 grid, each blob carrying its own direction."""
    import numpy as np

    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    rng = np.random.default_rng(seed)
    scalar = channels == 1
    shape = (512, 512, 288) if scalar else (384, 384, 192)
    axes = [np.arange(s, dtype=np.float32) for s in shape]
    dense = np.zeros(shape + (channels,), np.float32)
    for _ in range(24):
        c = rng.uniform(0, shape)
        s = rng.uniform(18, 48)
        weights = rng.uniform(0.3, 1.0, 1) if scalar else rng.uniform(-1.0, 1.0, channels)
        g = [np.exp(-((a - ci) ** 2) / (2 * s * s)).astype(np.float32)
             for a, ci in zip(axes, c)]
        for ch, amp in enumerate(weights.tolist()):
            dense[..., ch] += (amp * g[0][:, None, None] * g[1][None, :, None]
                               * g[2][None, None, :])
    np.clip(dense, 0.0 if scalar else -1.0, 1.0, out=dense)
    dense[np.abs(dense).max(axis=-1) < 0.02] = 0.0
    name = "density" if scalar else "velocity"
    full = LeafGrid.from_dense(name, dense)
    if full.num_leaves < n_leaves:
        raise RuntimeError(f"field has {full.num_leaves} active leaves, "
                           f"fewer than the {n_leaves} asked for")
    return LeafGrid(name=name, origins=full.origins[:n_leaves],
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
        rows.append(score_argmin_row("score_argmin", h_f32, h_bf16, m, c))

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


def log_kernel_rows(rows):
    """Log each row with its check (which then leaves the row) and times."""
    for row in rows:
        log(f"[kernel] {row['name']}: {row.pop('check')}; ms {row['ms']:.4f} "
            f"plain {row['plain_ms']:.4f} bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}) library {row['library_ms']}"
            + (f" eager {row['eager_ms']:.4f}" if "eager_ms" in row else ""))
    return rows


def _wrappers():
    from vqvdb_tpu_torch.ops import quantize as q
    from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused

    return {"dequantize": q.fused_dequantize,
            "score_argmin": q.fused_score_argmin,
            "nearest_indices": q.fused_nearest_indices,
            "fused_rb": residual_block_fused}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def round_trip(label, codec, grid, workdir: Path, min_psnr: float):
    """compress -> v3 -> decompress with the launch counters reset before
    and read after each half; checks shape, origins, finiteness and PSNR."""
    import numpy as np

    from vqvdb_tpu_torch.vdb.grid import psnr

    path = workdir / f"{label}.vqvdb"
    reset_launches()
    cstats = codec.compress(grid, path)
    enc = read_launches()
    reset_launches()
    dgrids, dstats = codec.decompress(path)
    dec = read_launches()
    out = dgrids[0]
    if out.leaves.shape != grid.leaves.shape or not np.isfinite(out.leaves).all():
        raise AssertionError(f"{label}: decoded leaves are not finite / of the input's shape")
    if not np.array_equal(out.origins, grid.origins):
        raise AssertionError(f"{label}: decoded origins differ from the input's")
    quality = psnr(out.leaves, grid.leaves)
    if not quality > min_psnr:
        raise AssertionError(f"{label}: round-trip PSNR {quality:.2f} dB <= {min_psnr}")
    return {
        "leaves": grid.num_leaves,
        "batches": -(-grid.num_leaves // codec.ccfg.batch_size),
        "compress_leaves_per_s": cstats["leaves_per_sec"],
        "decompress_leaves_per_s": dstats["leaves_per_sec"],
        "file_bytes": cstats["bytes"], "ratio": grid.leaves.nbytes / cstats["bytes"],
        "psnr_db": quality, "encode_launches": enc, "decode_launches": dec,
    }


def expect_launches(label, got, **want):
    """Every counter must read what `want` names, and 0 where it names none."""
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def main_path(tree, cfg, grid, workdir: Path):
    """Phase 3: the default codec's compress -> v3 -> decompress."""
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    codec = VQCodec(tree, cfg, CodecConfig(), device="cuda")
    codec.compress(grid_subset(grid, 5000), workdir / "warm.vqvdb")
    codec.decompress(workdir / "warm.vqvdb")
    torch.cuda.synchronize()

    result = round_trip("main", codec, grid, workdir, MIN_PSNR_DB)
    n = result["batches"]
    expect_launches("main path encode", result["encode_launches"], score_argmin=n)
    expect_launches("main path decode", result["decode_launches"], dequantize=n)
    return codec, result


def unfused_path(tree, cfg, grid, workdir: Path):
    """Phase 8: fuse_proj_quantize=False (nearest-code kernel) in f32,
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


def reference_path(grid, workdir: Path):
    """Phase 5: the reference-arch artifact at full width, fused residual
    block against the eager one."""
    import torch

    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    tree, cfg = load_model(REPO / "models" / "scalar_reference.vqmodel")
    fused = VQCodec(tree, cfg, CodecConfig(), device="cuda")
    eager = VQCodec(tree, cfg, CodecConfig(fuse_rb16=False), device="cuda")
    for codec in (fused, eager):
        codec.compress(grid_subset(grid, 5000), workdir / "warm.vqvdb")
    fused.decompress(workdir / "warm.vqvdb")
    torch.cuda.synchronize()

    res = round_trip("reference", fused, grid, workdir, MIN_PSNR_DB)
    n = res["batches"]
    expect_launches("reference encode", res["encode_launches"], fused_rb=n, score_argmin=n)
    expect_launches("reference decode", res["decode_launches"], dequantize=n)
    # A/B in turns on the same card: fused (above), eager, eager, fused.
    rates = {"fused": [res["compress_leaves_per_s"]], "eager": []}
    for name, codec in (("eager", eager), ("eager", eager), ("fused", fused)):
        reset_launches()
        stats = codec.compress(grid, workdir / "ab.vqvdb")
        expect_launches(f"reference {name} compress", read_launches(),
                        fused_rb=n if name == "fused" else 0, score_argmin=n)
        rates[name].append(stats["leaves_per_sec"])
    res["compress_leaves_per_s_fused_rb16"] = rates["fused"]
    res["compress_leaves_per_s_eager_rb16"] = rates["eager"]
    return tree, cfg, fused, res


def side_paths(seed: int, n_leaves: int, grid, workdir: Path):
    """Phase 6: the residual-VQ and the vec3 artifacts, default CodecConfig."""
    import torch

    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    out = {}
    t0 = time.perf_counter()
    vgrid = smooth_field(seed, n_leaves, channels=3)
    log(f"[data] {vgrid.num_leaves} 3-channel leaves ({vgrid.leaves.nbytes / 2**20:.0f} MiB "
        f"f32) from seed {seed} in {time.perf_counter() - t0:.1f} s")
    codecs = {}
    for label, data, floor in (("scalar_rvq2", grid_subset(grid, n_leaves), MIN_PSNR_DB),
                               ("vec3", vgrid, MIN_PSNR_VEC3_DB)):
        tree, cfg = load_model(REPO / "models" / f"{label}.vqmodel")
        codec = VQCodec(tree, cfg, CodecConfig(), device="cuda")
        codec.compress(grid_subset(data, 4096), workdir / "warm.vqvdb")
        codec.decompress(workdir / "warm.vqvdb")
        torch.cuda.synchronize()
        res = round_trip(label, codec, data, workdir, floor)
        n, s = res["batches"], cfg.num_quantizers
        if s > 1:
            expect_launches(f"{label} encode", res["encode_launches"],
                            nearest_indices=s * n, dequantize=s * n)
        else:
            expect_launches(f"{label} encode", res["encode_launches"], score_argmin=n)
        expect_launches(f"{label} decode", res["decode_launches"], dequantize=s * n)
        out[label] = res
        codecs[label] = (tree, cfg, codec)
    return codecs, vgrid, out


def score_argmin_row(name, h_f32, h_bf16, m, c):
    """One score-argmin row of the kernels line: f32 and bf16 rows [N, F]
    against the plain f32 scores, then the bf16 times."""
    import torch

    from vqvdb_tpu_torch.ops import quantize as q

    mis, ties, regret = index_check(name, q.fused_score_argmin(h_f32, m, c), h_f32 @ m + c)
    mis_b, ties_b, regret_b = index_check(
        f"{name} bf16", q.fused_score_argmin(h_bf16, m, c), h_bf16.float() @ m + c)
    f, k = m.shape
    n = h_bf16.shape[0]
    nbytes = n * f * 2 + m.numel() * 4 + k * 4 + n * 4
    flops = 2.0 * n * f * k
    return dict(
        name=name, route="cuda", source="vqvdb_tpu_torch/csrc/score_argmin.cu",
        replaces="vqvdb_tpu/ops/quantize.py:187",
        max_abs_err=max(regret, regret_b),
        ms=cuda_ms(lambda: q.fused_score_argmin(h_bf16, m, c)),
        plain_ms=cuda_ms(lambda: q.score_argmin_plain(h_bf16, m, c)),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
        bound_by="operations" if flops / F32_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=cuda_ms(lambda: torch.addmm(c, h_bf16.float(), m).argmin(1)),
        check=f"F={f}; f32: {mis} mismatches / {ties} near-tie rows; "
              f"bf16: {mis_b} / {ties_b}")


def side_kernel_phase(ref_codec, grid, vec_codec, vgrid):
    """Phase 7: the fused residual block and the wider score-argmin shapes."""
    import torch

    from vqvdb_tpu_torch.models import blocks
    from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused, residual_block_plain

    dev = ref_codec.device
    enc = ref_codec.params["encoder"]
    leaves = torch.from_numpy(grid.leaves[:4096]).to(dev)
    rows = []
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            # what pre_conv + pre_gn hand the block on the encode path
            h = blocks.conv3d(enc["pre_conv"], leaves.to(dtype), padding=1)
            h = torch.relu(blocks.group_norm(enc["pre_gn"], h, 4))
            dense = h.is_contiguous()
            h = h.contiguous()
            if tuple(h.shape) != (4096, 8, 8, 8, 16):
                raise AssertionError(f"fused_rb input has shape {tuple(h.shape)}")
            got = residual_block_fused(enc["pre_rb"], h)
            torch.cuda.synchronize()
            want = residual_block_plain(enc["pre_rb"], h, 8, 0.1)
            tol = RB_TOL[str(dtype).split(".")[1]]
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                raise AssertionError(f"fused_rb {dtype}: max abs err {err} beyond "
                                     f"atol = rtol = {tol}")
            flops = 2 * 2.0 * h.shape[0] * 512 * 27 * 16 * 16
            nbytes = 2 * h.numel() * h.element_size() + 2 * 27 * 16 * 16 * 4 + 6 * 16 * 4
            rows.append(dict(
                name="fused_rb" if dtype == torch.bfloat16 else "fused_rb_f32",
                route="cuda", source="vqvdb_tpu_torch/csrc/fused_rb.cu",
                replaces="vqvdb_tpu/ops/fused_rb.py:197", max_abs_err=err,
                ms=cuda_ms(lambda: residual_block_fused(enc["pre_rb"], h)),
                plain_ms=cuda_ms(lambda: residual_block_plain(enc["pre_rb"], h, 8, 0.1),
                                 iters=10, warmup=2),
                bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
                bound_by="operations" if flops / F32_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
                bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                library_ms=None,  # no single PyTorch call computes the whole block
                eager_ms=cuda_ms(lambda: blocks.residual_block(enc["pre_rb"], h)),
                check=f"{dtype}, groups 8, atol = rtol = {tol}; input dense NDHWC as "
                      f"GroupNorm hands it over: {dense}; eager block with cuDNN TF32 "
                      f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}"))

        for name, codec, data in (("score_argmin_width32", ref_codec, grid),
                                  ("score_argmin_width128", vec_codec, vgrid)):
            x = torch.from_numpy(data.leaves[:4096]).to(dev)
            h_bf16 = codec._features(x.to(torch.bfloat16))
            h_f32 = codec._features(x)
            f = h_f32.shape[-1]
            if h_bf16.numel() != BATCH_ROWS * f:
                raise AssertionError(f"{name}: wants {BATCH_ROWS} rows")
            rows.append(score_argmin_row(name, h_f32.reshape(-1, f),
                                         h_bf16.reshape(-1, f), *codec._score_mc))
    return rows


def staged_index_check(name, got, ref, stage_scores):
    """Indices got, ref [N, S] stage by stage: a row that differs at stage s
    must be a near-tie of stage_scores[s] (plain f32 scores of the reference
    side's residual); its later stages are not compared.
    Returns (rows that differ, near-tie rows of stage 0)."""
    import torch

    alive = torch.ones(got.shape[0], dtype=torch.bool)
    first_ties = 0
    for s, scores in enumerate(stage_scores):
        two = torch.topk(scores, 2, dim=1, largest=False).values
        ties = (two[:, 1] - two[:, 0]) < NEAR_TIE_REL * two[:, 0].abs().clamp(min=1.0)
        bad = alive & (got[:, s] != ref[:, s])
        off = int((bad & ~ties).sum())
        if off:
            raise AssertionError(f"{name}: {off} rows differ off near-ties at stage {s}")
        alive &= ~bad
        if s == 0:
            first_ties = int(ties.sum())
    return int((~alive).sum()), first_ties


def parity_phase(label, tree, cfg, grid):
    """Phase 9: the same 1,024 leaves through a cuda and a cpu codec in f32;
    one- or multi-stage indices, then decoded leaves."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.models.quantizer import dequantize, nearest_scores
    from vqvdb_tpu_torch.models.vqvae import encoder_apply
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    ccfg = CodecConfig(batch_size=1024, compute_dtype="float32")
    leaves = grid.leaves[:1024]
    cpu = VQCodec(tree, cfg, ccfg, device="cpu")
    gpu = VQCodec(tree, cfg, ccfg, device="cuda")
    idx_cpu = cpu.encode_leaves(leaves)
    reset_launches()
    idx_gpu = gpu.encode_leaves(leaves)
    launches = read_launches()
    s = cfg.num_quantizers
    ref = torch.from_numpy(idx_cpu.astype(np.int64)).reshape(-1, s)
    got = torch.from_numpy(idx_gpu.astype(np.int64)).reshape(-1, s)
    with torch.inference_mode():
        x = torch.from_numpy(leaves)
        if cpu._score_mc is not None:
            h = cpu._features(x)
            m, c = cpu._score_mc
            stage_scores = [h.reshape(-1, h.shape[-1]) @ m + c]
        else:
            res = encoder_apply(cpu.params["encoder"], x, cfg).reshape(-1, cfg.embedding_dim)
            stage_scores = []
            for st, codebook in enumerate(cpu.params["vq"]["embedding"]):
                stage_scores.append(nearest_scores(res, codebook))
                res = res - dequantize(ref[:, st], codebook)
    differ, ties = staged_index_check(f"{label} card vs cpu", got, ref, stage_scores)
    rec_cpu, rec_gpu = cpu.decode_indices(idx_cpu), gpu.decode_indices(idx_cpu)
    err = float(np.abs(rec_cpu - rec_gpu).max())
    if not err <= PARITY_ATOL:
        raise AssertionError(f"{label}: card vs cpu leaves differ by {err} > {PARITY_ATOL}")
    return {"model": label, "leaves": len(leaves), "rows_that_differ": differ,
            "near_tie_rows_stage0": ties, "leaf_max_abs_err": err, "atol": PARITY_ATOL,
            "launches": launches}


def profile_batches(codec, grid, out_dir: Path, prefix: str = ""):
    """--profile: torch.profiler over one steady encode and decode batch;
    the tables go to `out_dir` as profile_<prefix><encode|decode>.txt."""
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
        (out_dir / f"profile_{prefix}{name}.txt").write_text(table)
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
    ap.add_argument("--side-leaves", type=int, default=17161)
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
        kernels = log_kernel_rows(kernel_phase(codec, grid))
        if args.profile is not None:
            log(f"[profile] {json.dumps(profile_batches(codec, grid, args.profile))}")

        ref_tree, ref_cfg, ref_codec, ref_res = reference_path(grid, workdir)
        log(f"[reference] {json.dumps(ref_res)}")
        side, vgrid, side_res = side_paths(args.seed, args.side_leaves, grid, workdir)
        for label, res in side_res.items():
            log(f"[{label}] {json.dumps(res)}")
        kernels += log_kernel_rows(
            side_kernel_phase(ref_codec, grid, side["vec3"][2], vgrid))
        if args.profile is not None:
            prof = profile_batches(ref_codec, grid, args.profile, "reference_")
            log(f"[profile reference] {json.dumps(prof)}")

        torch.backends.cudnn.allow_tf32 = False
        unf = unfused_path(tree, cfg, grid_subset(grid, 16384 + 777), workdir)
        log(f"[unfused] {json.dumps(unf)}")
    par = {}
    for label, (t, c) in (("scalar", (tree, cfg)), ("scalar_reference", (ref_tree, ref_cfg)),
                          ("scalar_rvq2", side["scalar_rvq2"][:2])):
        par[label] = parity_phase(label, t, c, grid)
        log(f"[parity] {json.dumps(par[label])}")
    expect_launches("scalar_rvq2 f32 encode", par["scalar_rvq2"]["launches"],
                    nearest_indices=2, dequantize=2)

    # Each row's count comes from the path that runs the kernel at the row's
    # shape and type, counters reset just before that path and read just after.
    launches = {"dequantize": main_res["decode_launches"]["dequantize"],
                "score_argmin": main_res["encode_launches"]["score_argmin"],
                "nearest_indices": unf["launches"]["nearest_indices"]}
    launches["fused_rb"] = ref_res["encode_launches"]["fused_rb"]
    launches["fused_rb_f32"] = par["scalar_reference"]["launches"]["fused_rb"]
    launches["score_argmin_width32"] = ref_res["encode_launches"]["score_argmin"]
    launches["score_argmin_width128"] = side_res["vec3"]["encode_launches"]["score_argmin"]
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
