#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vqvdb_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--leaves 70000] [--side-leaves 17161]
                          [--profile DIR] [--ranks N] [--mesh-only]

Phases, in this order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1.
  2. build: compile every CUDA kernel of the package from its sources, and
     the native LZ4 library (`native/vqvdb_native.cpp`, g++).
  3. main path: the flagship `models/scalar.vqmodel` (packed scalar, K=256,
     D=128) at full width, default CodecConfig (bf16, batch 4096):
     compress a seeded smooth field of --leaves leaves to a v3 file and
     decompress it, with every kernel launch counter reset just before and
     read just after.
  4. kernels: each kernel against its plain PyTorch version at the codec's
     batch (4096 leaves = 262,144 latent rows), on the flagship model's own
     features; kernel, plain, bound and library-call times. The score
     kernel's indices must equal the argmin of plain f32 scores except on
     near-ties, miss the argmin of f64 scores on at most 0.5% of rows
     (plain f32's own count is logged beside it), and equal the plain
     version's on rows with a NaN or an infinity planted.
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
     bf16 and f32 on the reference model's own features (against the plain
     version, bit-equal on repeat, on leaves with NaN / inf planted, and
     timed with nvidia-smi sampling clocks and power beside the loop), and
     score-argmin at feature widths 32 (reference arch) and 128 (vec3).
  8. unfused path: fuse_proj_quantize=False (the nearest-code kernel) in
     f32, counters reset around it; its indices must equal the fused f32
     path's except on near-ties.
  9. parity: 1,024 leaves through a `cuda` and a `cpu` codec in f32 (TF32
     off for cuDNN and cuBLAS), for every shipped artifact: the flagship,
     the reference arch, the residual-VQ model and packed_lite on the scalar
     field, vec3 and vec3_rvq2 on the 3-channel one. A residual-VQ row
     (two nearest-code and two dequantize launches per encode batch) is
     compared stage by stage:
     a row that differs at a stage must be a near-tie of that stage's
     scores, and its later stages (which code another residual) are skipped.
 10. container tiers: the phase-3 codec compresses and decompresses the
     --leaves leaves to v5 (zlib, lz4, lzma) and v6 (int8, int8 with
     residual_tol under zlib and under lz4, f16), counters around each half; each logs its rates,
     bytes, ratio to raw f32, PSNR, max error and the host's milliseconds
     per batch for frame writing / reading and residual quantization /
     correction. Then it fails unless: verify_roundtrip of the v6 int8 file
     gives bound_ok; the decode step's rows do not depend on the batch's
     other (padded) rows, bit for bit; compress_stream writes the v6 int8
     file byte for byte; a bounding-box decode_stream equals decompress on
     its origins; transcode v6 -> v5 (drop_residual) keeps the indices. The
     residual-VQ model also runs v6 f16 on --side-leaves leaves (the
     nearest-code kernel inside the residual pass).
 11. large codebook: the flagship with its codebook grown to K=4096 (the
     256 trained codes, then trained codes plus seeded noise) at full width
     through v4 (u16 indices, some above 255), with the score kernel's 16
     code tiles per batch counted; then the kernel row `score_argmin_k4096`
     at F=64, K=4096 as in phase 4.
 12. user path: the flagship at full width on the --leaves leaves written as
     an OpenVDB .vdb (`vdb/openvdb_io.py`): `vqvdb_tpu_torch.cli` encode to
     .vqvdb (and encode --streaming), both byte-identical to compress of
     the grid the .vdb holds; decode to .vdb, equal to decompress and above
     the PSNR floor; `api.decode_dense` of the v3 file and of a v6-int8 file
     (a CUDA tensor, bit-equal to decompress + LeafGrid.to_dense, the int8
     bound held), one dequantize launch per decode step; `api.encode_dense`
     from that tensor, byte-identical to compress(LeafGrid.from_dense(...)),
     one score-argmin launch per encode step; then dense and sparse rates in
     turns.
 13. deep rows: derived models of the flagship's graph with weights from
     --seed take the kernels where no shipped model does: the score kernel
     on f32 rows of depth 160 and bf16 rows of depth 1024 and the
     nearest-code kernel at D = 160 (the streamed-depth mode), and the
     dequantize kernel on 40-byte bf16 rows (D = 20), each on a codec path
     with counters around it, then against its plain version.
 14. training: the flagship's ModelConfig at full width with the default
     TrainConfig (batch 2048, bf16), 2 epochs over the phase-3 leaves (80/20
     split): (1) one f32 train step (TF32 off) on 256 leaves from the same
     params on the card and the CPU: gradients within TRAIN_GRAD_TOL of the
     largest entry, params within the Adam-step tolerance, EMA state within
     TRAIN_EMA_RTOL off near-tie codes; (2) the host loop `train` with the
     counters around it (one nearest-code and one dequantize launch per
     train step and val batch), recon loss falling; (3) `train_on_device`
     with the same counts, equal to the host loop over its permutation
     within FAST_TOL (cuDNN deterministic), and an epoch of it with no
     host sync (CUDA sync debugging raising); (4) checkpoints and a resume
     that equals the uninterrupted run; (5) the trained params through
     save_model -> VQCodec -> v3 and evaluate_codec / codebook_report,
     above the initial params' PSNR; (6) 2 steps of the reference arch and of
     scalar_rvq2; (7) steps/s and leaves/s of one epoch of the host loop and
     the fast path in turns; --profile adds a profiled train step. Then the
     kernel rows nearest_indices_train and dequantize_train at a step's
     shapes.
 15. serving and interop: (1) the flagship (batch 4096, bf16) behind
     `serving.py` on 127.0.0.1:0: 32 client threads x 8 /encode_leaves
     requests of 256-1024 leaves cut from the field (sizes from --seed) and
     a malformed one (3 channels) among them, then a /decode_indices request
     for each answer, counters reset around each window; every answer must
     equal the codec's encode_leaves / decode_indices of its rows, the
     malformed request alone fails (400), requests coalesce (steps <
     requests), one score-argmin launch per encode batch and one dequantize
     launch per decode batch; an /encode of a 16,384-leaf .npy byte-identical
     to compress of the service's grid and its /decode equal to decompress;
     /stats holds the device/dispatch profile; rates and p50 / p99 latency
     of the same traffic from 32 clients and from one, in turns (concurrent,
     serial, serial, concurrent). (2) `export-onnx --embed-header` of the
     flagship and the reference arch, validated on the card (one
     nearest-code and two dequantize launches each); `export-torch` of the
     reference arch, its TorchScript decode of 64 index blocks on the card
     within 1e-5 of decode_from_indices; the Houdini cooks (grids=) on the
     card byte-identical to api.encode / api.decode. Logs `[serve] {...}`
     and `[interop] {...}`.
 16. mesh (`parallel/`): (1) the flagship (batch 4096, bf16) on
     VQCodec(mesh=make_mesh()) over every visible card: its v3 and v6-int8
     files of the --leaves leaves byte-identical to the phase-3 codec's
     (phases 3 and 10), decompress and decode_to_dense bit-identical, one
     score-argmin (dequantize) launch per shard step, and the rates of the
     mesh and plain codecs in turns; (2) an in-process NCCL group of one
     rank on a file store: three flagship-config train steps (batch 2048,
     bf16, cuDNN deterministic) under group= bit-equal to three without it,
     and the multi-process codec's v3 file equal to phase 3's; (3) with
     --ranks N > 1, N NCCL ranks over N cards (torch.multiprocessing): every
     rank's v3 and v6-int8 files byte-identical to phase 3's, and three f32
     train steps (TF32 off) of the ranks bit-identical to each other and
     within rtol 2e-4 / atol 2e-5 of one process on the global batches.
     --mesh-only runs phases 1-3, 16 and 18 alone. Logs `[mesh] <part> {...}`.
 17. packed_stem and the folded final conv: (1) a packed_stem model at the
     flagship's widths trained from seeded init on the card (one resident
     epoch over the --leaves leaves, batch 2048, bf16; one nearest-code and
     one dequantize launch per step and val batch), through save_model ->
     VQCodec -> v3 (one score-argmin launch per batch) above its initial
     params' PSNR; (2) phase 9's card-vs-CPU parity on it; (3) the flagship
     decoded through the folded final conv (fuse_decoder_tail=False, f32,
     TF32 off) within 1e-5 of the fused tail. Logs `[stem] <part> {...}`.
 18. layout: (1) `tools/batch_invariance.py` on the card: every stage of the
     encode and decode steps of the flagship, the reference arch and
     scalar_rvq2 (convs, GroupNorm, attention, tail, the four kernels)
     gives a row the same bits in blocks of 2,048, 1,024, 512 and 256 rows
     as in a 4,096-row batch, in bf16 and f32 (TF32 off); its JSON is
     logged; (2) meshes of 2, 4, 8 and 16 entries on the one card
     (`Mesh((cuda:0,) * n, n)`: a stream each, shards of 2,048 down to 256
     rows, the shapes that 2-16 cards run): the flagship's v3 and v6-int8
     files, the reference arch's and scalar_rvq2's v3 files byte-identical
     to phases 3, 10, 5 and 6's, decompress and the flagship's dense decode
     bit-identical, one launch per kernel, stage and shard step; (3) with
     several cards, the flagship on a mesh of every card at batch 4096,
     2048 and 1024 against one card at the same batch size. Logs
     `[layout] <part> {...}`.
 19. bench: `vqvdb_tpu_torch.bench.run(data_parallel=True)`, what `python
     -m vqvdb_tpu_torch.bench --data-parallel` prints (`cli bench` prints
     it without the data-parallel keys): the decode and encode rates of the
     device program (a step captured in a CUDA graph, replayed, fenced by a
     readback), vec3, residual-VQ and dense rows, the reference-shaped
     baseline, the MFU, and `bench.py --data-parallel`'s eight keys (the
     mesh codec over every visible card on a 100,000-leaf file and the host
     stages of its step). Every rate and time must be finite and > 0,
     `mesh_devices` the visible cards, each captured
     row's replay bit-equal to its eager step, each capture must record its
     row's kernel launches, and on an H100 SXM the decode and encode MFU
     lie in (0, 1]. Then the baseline's batch-64 step against the same step
     at 1,024 rows in turns (the padding of `models/blocks.py`). Logs
     `[bench] card: <nvidia-smi>`, `[bench] {...}` (the bench's line),
     `[bench] rows [...]` and `[bench] padding {...}`.
 20. data-parallel bench: `vqvdb_tpu_torch.bench_dp.bench_mesh_size` (the
     reference arch, untrained, bf16, batch 2,048, 100,000 leaves) with no
     mesh, on a mesh of every visible card and on one-card meshes of 2, 4
     and 8 entries (the shard shapes of 2-, 4- and 8-card hosts): compress,
     the timed `decode_stream` rate, and on a mesh the host stages (scatter,
     full gather, the codec's per-shard gather, the fenced step) and the
     host-bound ceilings. Every rate and time must be finite and > 0, the
     per-shard gather bit-equal to the full gather, each row's file and
     decoded leaves the no-mesh row's, and score-argmin and the fused block
     (in the compress) and dequantize (in the timed pass) launched once per
     shard step: 49 / 98 / 196 / 391 on meshes of 1 / 2 / 4 / 8. Logs
     `[dp] <mesh>: {...}` per row and `[dp] card: <nvidia-smi>`.
Phases 3 and 15-20 log their seconds (`[phaseN]`).
Then one JSON line of kernel numbers, the nvidia-smi line, and last the
result line {"ok": true, "device": {...}}. Phase 2 also counts the
tensor-core instructions in each library's SASS (cuobjdump) and fails if an
MMA kernel has none. --profile DIR also times one steady encode and decode
batch of the flagship, the reference arch, the residual-VQ model and the
vec3 model under torch.profiler and writes the profiler tables, the
nvcc/ptxas report and the SASS to DIR; without it no file is written
outside a temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA-core f32
BF16_FLOPS = 989e12  # tensor cores, dense bf16 with f32 sums
BATCH_ROWS = 4096 * 64
NEAR_TIE_REL = 1e-4  # best-vs-runner-up score gap, relative to |best|
MAX_MISMATCH_SHARE = 0.005  # of rows off the f64 argmin: more means too few terms
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


def cuda_ms(fn, iters: int = 50, warmup: int = 5, graph: bool = False) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events).
    With `graph` the calls are captured once into a CUDA graph and replayed,
    so a kernel of tens of microseconds is timed without the host's enqueue
    time between launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run, reps = (lambda: [fn() for _ in range(iters)]), 1
    if graph:
        stream = torch.cuda.Stream()
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), torch.cuda.graph(cuda_graph, stream=stream):
            run()
        run, reps = cuda_graph.replay, 4
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


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


def terms_check(name, got, plain_scores, exact_scores):
    """Whether the split products keep enough terms: indices `got` against
    the argmin of the same scores in f64. Plain f32 scores miss that argmin
    on some near-tie rows themselves, so the count against them cannot tell a
    kernel that rounds differently from one that rounds worse; the f64 argmin
    can. Fails above MAX_MISMATCH_SHARE of the rows.
    Returns (rows where the kernel misses, rows where plain f32 misses)."""
    best = exact_scores.argmin(1)
    missed = int((got.long() != best).sum())
    plain_missed = int((plain_scores.argmin(1) != best).sum())
    if missed > MAX_MISMATCH_SHARE * got.numel():
        raise AssertionError(
            f"{name}: {missed} of {got.numel()} rows miss the f64 argmin, more than "
            f"{MAX_MISMATCH_SHARE:.1%} (plain f32 scores miss it on {plain_missed})")
    return missed, plain_missed


def tc_bound(nbytes, flops, products):
    """A tensor-core kernel's bound in ms: `nbytes` (inputs read once,
    outputs written once) at the memory rate, or `products` bf16 MMAs per
    f32-grade product of `flops` operations at the tensor cores' rate; and
    the f32 CUDA-core bound that the first version of each kernel was held
    to."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, products * flops / BF16_FLOPS
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="operations" if by_ops > by_bytes else "bytes",
                products=products, bytes_bound_ms=by_bytes * 1e3,
                f32_core_bound_ms=max(by_bytes, flops / F32_FLOPS) * 1e3)


def score_bound(n, f, k, row_bytes, products):
    """The score kernel's bound: rows, M and c read, indices written."""
    return tc_bound(n * f * row_bytes + f * k * 4 + k * 4 + n * 4, 2.0 * n * f * k, products)


def non_finite_check(name, rows, fn, plain):
    """Rows with a NaN, +inf, -inf or both infinities planted, spread over
    the batch: the kernel's indices there must equal the plain version's."""
    import torch

    x = rows.clone()
    n = x.shape[0]
    planted = []
    for start, col, val in ((5, 3, float("nan")), (17, 1, float("inf")),
                            (29, 2, float("-inf")), (41, 0, float("inf"))):
        idx = torch.arange(start, n, 1009, device=x.device)
        x[idx, col] = val
        planted.append(idx)
    x[planted[3], 4] = float("-inf")  # both infinities in one row
    sel = torch.cat(planted)
    got, want = fn(x)[sel].long(), plain(x)[sel].long()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} of {sel.numel()} rows "
                             "with a NaN or an infinity differ from the plain version")
    return sel.numel()


def kernel_phase(codec, grid):
    """Phase 4: each kernel against its plain version at main-path shapes."""
    import torch

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
        idx_u8 = q.fused_score_argmin(h_bf16, m, c).to(torch.uint8)
        rows.append(dequantize_row("dequantize", idx_u8, emb))

        # -- score-argmin: h [N, 64] (f32 check, bf16 as the encode step runs)
        rows.append(score_argmin_row("score_argmin", h_f32, h_bf16, m, c))
        rows.append(score_argmin_row("score_argmin_f32", h_f32, h_bf16, m, c, timed=h_f32))

        # -- nearest: z [N, 128] f32 against the codebook
        rows.append(nearest_row("nearest_indices", z, emb))
    return rows


def dequantize_row(name, idx_u8, emb):
    """The dequantize kernel on u8 indices and the codebook in bf16 (the
    decode step's), and on int32 indices with some out of range in bf16 and
    f32: bit-equal to the plain version, zero rows out of range."""
    import torch

    from vqvdb_tpu_torch.models.quantizer import dequantize
    from vqvdb_tpu_torch.ops import quantize as q

    n = idx_u8.shape[0]
    cb = emb.to(torch.bfloat16)
    got = q.fused_dequantize(idx_u8, cb)
    err = (got.float() - dequantize(idx_u8, cb).float()).abs().max().item()
    if not torch.equal(got, dequantize(idx_u8, cb)):
        raise AssertionError(f"{name}: kernel rows differ from plain")
    idx_i32 = idx_u8.to(torch.int32)
    idx_i32[::9973] = emb.shape[0] + 44  # out of range -> zero rows
    idx_i32[1::9973] = -1
    for cbx in (cb, emb):
        got = q.fused_dequantize(idx_i32, cbx)
        if not torch.equal(got, dequantize(idx_i32, cbx)):
            raise AssertionError(f"{name}: int32/{cbx.dtype} differs from plain")
        if got[::9973].any() or got[1::9973].any():
            raise AssertionError(f"{name}: out-of-range rows are not zero")
    d = cb.shape[1]
    nbytes = n * 1 + cb.numel() * 2 + n * d * 2
    idx_lib = idx_u8.to(torch.int32)
    return dict(
        name=name, route="cuda", source="vqvdb_tpu_torch/csrc/dequantize.cu",
        replaces="vqvdb_tpu/ops/quantize.py:110",
        max_abs_err=err,
        ms=cuda_ms(lambda: q.fused_dequantize(idx_u8, cb), graph=True),
        plain_ms=cuda_ms(lambda: dequantize(idx_u8, cb)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: cb.index_select(0, idx_lib)),
        check=f"D={d} ({d * 2} B bf16 rows), bit-equal, u8 and int32 (out-of-range rows "
              "zero), bf16 and f32")


def nearest_row(name, z, emb, prepared=True):
    """The nearest-code kernel on f32 latents z [N, D] against the codebook:
    the argmin of plain f32 scores off near-ties, the f64 argmin, planted
    non-finite rows; times with the codebook prepared once (or, with
    `prepared` False, on every call, as a train step runs it)."""
    import torch

    from vqvdb_tpu_torch.models.quantizer import nearest_indices, nearest_scores
    from vqvdb_tpu_torch.ops import quantize as q

    scores = nearest_scores(z, emb)
    got = q.fused_nearest_indices(z, emb)
    mis, ties, regret = index_check(name, got, scores)
    e64 = emb.double()
    missed, plain_missed = terms_check(
        name, got, scores, (e64 * e64).sum(1)[None, :] - 2.0 * (z.double() @ e64.T))
    planted = non_finite_check(name, z, lambda x: q.fused_nearest_indices(x, emb),
                               lambda x: nearest_indices(x, emb))
    esq = (emb * emb).sum(1)
    mt = -2.0 * emb.T
    prep = q.prepare_codebook(emb)
    return dict(
        name=name, route="cuda", source="vqvdb_tpu_torch/csrc/score_argmin_tc.cu",
        replaces="vqvdb_tpu/ops/quantize.py:41",
        max_abs_err=regret, mismatches=mis,
        ms=cuda_ms(lambda: q.fused_nearest_indices(z, prep if prepared else emb), graph=True),
        plain_ms=cuda_ms(lambda: nearest_indices(z, emb)),
        **score_bound(z.shape[0], z.shape[1], emb.shape[0], 4, products=6),
        library_ms=cuda_ms(lambda: torch.addmm(esq, z, mt).argmin(1)),
        check=f"D={z.shape[1]} f32: {mis} mismatches / {ties} near-tie rows, max regret "
              f"{regret:.3g}, off the f64 argmin {missed} (plain f32: {plain_missed}); "
              f"{planted} non-finite rows equal plain")


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


def score_argmin_row(name, h_f32, h_bf16, m, c, timed=None):
    """One score-argmin row of the kernels line: f32 and bf16 rows [N, F]
    against the plain f32 scores and on planted non-finite rows, then the
    times of `timed` (default: the bf16 rows) with M prepared once, as the
    codec calls the kernel."""
    import torch

    from vqvdb_tpu_torch.ops import quantize as q

    stats = []
    for label, rows in ((name, h_f32), (f"{name} bf16", h_bf16)):
        got, plain = q.fused_score_argmin(rows, m, c), rows.float() @ m + c
        stats.append(index_check(label, got, plain)
                     + terms_check(label, got, plain, rows.double() @ m.double() + c.double()))
    (mis, ties, regret, missed, plain_missed), (mis_b, ties_b, regret_b, missed_b, plain_missed_b) = stats
    planted = sum(non_finite_check(f"{name} {h.dtype}", h,
                                   lambda x: q.fused_score_argmin(x, m, c),
                                   lambda x: q.score_argmin_plain(x, m, c))
                  for h in (h_f32, h_bf16))
    h = h_bf16 if timed is None else timed
    f, k = m.shape
    prep = q.prepare_scores(m, c)
    cc, hf = c.reshape(-1), h.float()
    return dict(
        name=name, route="cuda", source="vqvdb_tpu_torch/csrc/score_argmin_tc.cu",
        replaces="vqvdb_tpu/ops/quantize.py:187",
        max_abs_err=max(regret, regret_b), mismatches=max(mis, mis_b),
        ms=cuda_ms(lambda: q.fused_score_argmin(h, prep), graph=True),
        plain_ms=cuda_ms(lambda: q.score_argmin_plain(h, m, c)),
        **score_bound(h.shape[0], f, k, h.element_size(),
                      products=3 if h.dtype == torch.bfloat16 else 6),
        library_ms=cuda_ms(lambda: torch.addmm(cc, hf, m).argmin(1)),
        check=f"F={f}, timed with {h.dtype} rows; f32: {mis} mismatches / {ties} near-tie "
              f"rows, max regret {regret:.3g}, off the f64 argmin {missed} (plain f32: "
              f"{plain_missed}); bf16: {mis_b} / {ties_b}, {regret_b:.3g}, {missed_b} "
              f"({plain_missed_b}); {planted} non-finite rows equal plain")


RB_TAP_PAIRS = 22 ** 3  # (voxel, tap) pairs of a leaf inside the SAME padding


def rb_bound(n_leaves, elem_bytes, products):
    """The fused residual block's bound: x read, out written, the weights;
    two convs of 2 n 16 16 operations per (voxel, tap) pair that does not
    fall on the zero padding. Along each axis the 8 positions see
    2 + 6 * 3 + 2 = 22 valid taps, so a leaf has 22^3 such pairs, 77% of
    512 * 27."""
    nbytes = 2 * n_leaves * 512 * 16 * elem_bytes + 2 * 27 * 16 * 16 * 4 + 6 * 16 * 4
    return tc_bound(nbytes, 2 * 2.0 * n_leaves * RB_TAP_PAIRS * 16 * 16, products)


def sampled_ms(fn, seconds: float = 1.0):
    """cuda_ms of fn() over a loop of about `seconds`, with nvidia-smi
    sampling the SM clock, power draw and temperature every 50 ms beside it.
    Returns (ms, {"sm_mhz": [min, max], "power_w": [min, max], "temp_c":
    [min, max], "samples": n})."""
    import threading

    def call():  # keeps no output alive across the loop's launches
        fn()

    once = cuda_ms(call, iters=10, warmup=3)
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    lines, first = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            first.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        first.wait(timeout=30)
        start = len(lines)
        ms = cuda_ms(call, iters=max(50, int(seconds * 1e3 / once)), warmup=0)
        window = lines[start:]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        reader.join(timeout=30)
    rows = []
    for line in window:
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    clocks = {key: [min(r[i] for r in rows), max(r[i] for r in rows)] if rows else None
              for i, key in enumerate(("sm_mhz", "power_w", "temp_c"))}
    clocks["samples"] = len(rows)
    return ms, clocks


def rb_non_finite_check(name, params, h, tol):
    """Leaves with a NaN, +inf, -inf or both infinities planted, spread over
    the batch: the kernel must give NaN exactly where the plain version does
    (the whole planted leaf: its GroupNorm statistics are NaN) and agree
    within `tol` everywhere else."""
    import torch

    from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused, residual_block_plain

    x = h.clone()
    n = x.shape[0]
    planted = []
    for start, val in ((5, float("nan")), (17, float("inf")), (29, float("-inf")),
                       (41, float("inf"))):
        idx = torch.arange(start, n, 509, device=x.device)
        x[idx, 3, 4, 5, (start // 4) % 16] = val
        planted.append(idx)
    x[planted[3], 0, 7, 7, 0] = float("-inf")  # both infinities in one leaf
    got = residual_block_fused(params, x).float()
    want = residual_block_plain(params, x, 8, 0.1).float()
    sel = torch.cat(planted)
    if not (torch.isnan(got[sel]).all() and torch.equal(torch.isnan(got), torch.isnan(want))):
        raise AssertionError(f"{name}: NaN pattern differs from the plain version")
    if not torch.allclose(got, want, atol=tol, rtol=tol, equal_nan=True):
        raise AssertionError(f"{name}: leaves without a planted value differ beyond {tol}")
    return sel.numel()


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
            if not torch.equal(residual_block_fused(enc["pre_rb"], h), got):
                raise AssertionError(f"fused_rb {dtype}: a second launch gave other bits")
            planted = rb_non_finite_check(f"fused_rb {dtype}", enc["pre_rb"], h, tol)
            ms, clocks = sampled_ms(lambda: residual_block_fused(enc["pre_rb"], h))
            rows.append(dict(
                name="fused_rb" if dtype == torch.bfloat16 else "fused_rb_f32",
                route="cuda", source="vqvdb_tpu_torch/csrc/fused_rb_tc.cu",
                replaces="vqvdb_tpu/ops/fused_rb.py:197", max_abs_err=err,
                ms=ms,
                plain_ms=cuda_ms(lambda: residual_block_plain(enc["pre_rb"], h, 8, 0.1),
                                 iters=10, warmup=2),
                **rb_bound(h.shape[0], h.element_size(),
                           products=3 if dtype == torch.bfloat16 else 6),
                library_ms=None,  # no single PyTorch call computes the whole block
                eager_ms=cuda_ms(lambda: blocks.residual_block(enc["pre_rb"], h)),
                clocks_during_ms=clocks,
                check=f"{dtype}, groups 8, atol = rtol = {tol}, bit-equal on repeat, "
                      f"{planted} leaves with NaN/inf planted as plain; input dense NDHWC "
                      f"as GroupNorm hands it over: {dense}; eager block with cuDNN TF32 "
                      f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}; during the "
                      f"timing loop {clocks}"))

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


def mma_counts(out_dir):
    """Counts of tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma) in
    the SASS of each built kernel library, from cuobjdump next to nvcc; the
    MMA kernels must have some. With `out_dir` the SASS is written there as
    sass_<name>.txt."""
    import os

    from vqvdb_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    counts = {}
    for name in build.SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(build._target(name))], check=True,
                              capture_output=True, text=True, timeout=120).stdout
        if out_dir is not None:
            (out_dir / f"sass_{name}.txt").write_text(sass)
        counts[name] = {op: sum(f" {op}." in line for line in sass.splitlines())
                        for op in ("HMMA", "HGMMA")}
    for name in ("score_argmin_tc", "fused_rb_tc"):
        if not sum(counts[name].values()):
            raise AssertionError(f"{name}: no tensor-core instruction in its SASS")
    return counts


RESIDUAL_TOL = 1e-3
TIERS = (("v5_zlib", dict(format_version=5, compression="zlib")),
         ("v5_lz4", dict(format_version=5, compression="lz4")),
         ("v5_lzma", dict(format_version=5, compression="lzma")),
         ("v6_int8", dict(residual="int8")),
         ("v6_int8_tol", dict(residual="int8", residual_tol=RESIDUAL_TOL)),
         ("v6_int8_tol_lz4", dict(residual="int8", residual_tol=RESIDUAL_TOL,
                                  compression="lz4")),
         ("v6_f16", dict(residual="f16")))


def _file_indices(path):
    """Every grid's indices of a file, in order, as one array."""
    import numpy as np

    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader

    out = []
    with VqvdbReader(path) as r:
        for _, batches in r.iter_grids():
            out += [idx for idx, _ in batches]
    return np.concatenate(out)


def tier_round_trip(label, codec, grid, path, **opts):
    """compress -> decompress on one container tier, counters reset before
    and read after each half; rates, size, error and the host's share per
    batch (frame writing and reading, residual quantization and correction)."""
    import numpy as np

    from vqvdb_tpu_torch.vdb.grid import psnr

    reset_launches()
    cstats = codec.compress(grid, path, **opts)
    enc = read_launches()
    reset_launches()
    dgrids, dstats = codec.decompress(path)
    dec = read_launches()
    out = dgrids[0]
    if out.leaves.shape != grid.leaves.shape:
        raise AssertionError(f"{label}: decoded leaves of shape {out.leaves.shape}, "
                             f"the input's is {grid.leaves.shape}")
    finite = np.isfinite(out.leaves.reshape(out.leaves.shape[0], -1)).all(1)
    if not finite.all():
        rows = np.flatnonzero(~finite)
        raise AssertionError(
            f"{label}: {rows.size} decoded leaves are not finite, in batches "
            f"{sorted(set((rows // codec.ccfg.batch_size).tolist()))} (first {rows[:8]})")
    if not np.array_equal(out.origins, grid.origins):
        raise AssertionError(f"{label}: decoded origins differ from the input's")
    batches = -(-grid.num_leaves // codec.ccfg.batch_size)
    s = codec.mcfg.num_quantizers
    if codec._score_mc is not None:
        want = {"score_argmin": batches * codec._score_prep.tiles, "dequantize": 0}
    else:
        want = {"nearest_indices": s * batches, "dequantize": s * batches}
    if opts.get("residual"):  # the encode batches run the decode step too
        want["dequantize"] += s * batches
    expect_launches(f"{label} encode", enc, **want)
    expect_launches(f"{label} decode", dec, dequantize=s * batches)
    per_batch = {k: v / batches * 1e3 for k, v in
                 {**cstats["host_seconds"], **dstats["host_seconds"]}.items()}
    quality = psnr(out.leaves, grid.leaves)
    if not quality > MIN_PSNR_DB:
        raise AssertionError(f"{label}: round-trip PSNR {quality:.2f} dB <= {MIN_PSNR_DB}")
    return {
        "compress_leaves_per_s": cstats["leaves_per_sec"],
        "decompress_leaves_per_s": dstats["leaves_per_sec"],
        "file_bytes": cstats["bytes"], "ratio": grid.leaves.nbytes / cstats["bytes"],
        "psnr_db": quality, "max_abs_err": float(np.abs(out.leaves - grid.leaves).max()),
        "host_ms_per_batch": per_batch, "encode_launches": enc, "decode_launches": dec,
    }


class _Stream:
    """A grid read lazily in pieces, as compress_stream takes it."""

    def __init__(self, grid, piece):
        self.grid, self.piece = grid, piece
        self.name, self.transform, self.origins = grid.name, grid.transform, grid.origins
        self.num_leaves, self.channels = grid.num_leaves, grid.channels

    def leaf_batches(self, batch_size):
        for s in range(0, self.num_leaves, self.piece):
            yield self.grid.leaves[s: s + self.piece]


def tier_phase(codec, grid, workdir: Path):
    """Phase 10: the flagship on the v5 and v6 tiers, then the checks that
    hold the tiers to the codec: the int8 bound, row independence of the
    decode step, compress_stream, a bounding-box stream and transcode."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.format.transcode import transcode
    from vqvdb_tpu_torch.format.verify import verify_roundtrip

    out = {}
    for label, opts in TIERS:
        out[label] = tier_round_trip(label, codec, grid, workdir / f"{label}.vqvdb", **opts)
        log(f"[tiers] {label}: {json.dumps(out[label])}")
    checks = {}
    v6 = workdir / "v6_int8.vqvdb"
    report = verify_roundtrip(v6, codec, [grid])
    row = report["grids"][0]
    if not (report["ok"] and row["bound_ok"]):
        raise AssertionError(f"v6 int8 verify_roundtrip: {json.dumps(report)}")
    checks["verify_roundtrip_v6_int8"] = {k: row[k] for k in (
        "matched_leaves", "max_abs_err", "residual_bound", "bound_ok", "psnr_db")}
    # The bound needs the encode-time decode to equal the decompress one bit
    # for bit, and the two batches differ in their padded rows.
    bs = codec.ccfg.batch_size
    idx = torch.from_numpy(_file_indices(v6)[:bs]).cuda()
    rows = grid.num_leaves % bs or bs // 2
    padded = idx.clone()
    padded[rows:] = torch.randint_like(padded[rows:], 0, codec.mcfg.num_embeddings)
    padded[:rows] = idx[:rows]
    a, b = codec._decode_step(idx), codec._decode_step(padded)
    if not torch.equal(a[:rows], b[:rows]):
        raise AssertionError("decode step: rows depend on the batch's other rows")
    checks["decode_rows_independent"] = {"rows": rows, "bit_equal": True}
    streamed = workdir / "stream.vqvdb"
    codec.compress_stream(_Stream(grid, 1000), streamed, residual="int8")
    if streamed.read_bytes() != v6.read_bytes():
        raise AssertionError("compress_stream of the grid differs from its compress")
    checks["compress_stream_byte_identical"] = True
    lo, hi = grid.origins.min(0), grid.origins.max(0) + 8
    box = (lo, (lo + hi) // 2)
    whole, _ = codec.decompress(v6)
    at = {o.tobytes(): i for i, o in enumerate(whole[0].origins)}
    picked = 0
    for meta, leaves, origins in codec.decode_stream(v6, bbox=box):
        sel = [at[o.tobytes()] for o in origins]
        if not np.array_equal(leaves, whole[0].leaves[sel]):
            raise AssertionError("bbox decode_stream differs from decompress on its origins")
        picked += len(sel)
    if not 0 < picked < grid.num_leaves:
        raise AssertionError(f"bbox picked {picked} leaves")
    checks["bbox_decode_stream_equal"] = {"leaves": picked, "bit_equal": True}
    t = transcode(v6, workdir / "dropped.vqvdb", version=5, compression="lz4",
                  drop_residual=True)
    if not np.array_equal(_file_indices(workdir / "dropped.vqvdb"), _file_indices(v6)):
        raise AssertionError("transcode v6 -> v5 changed the indices")
    checks["transcode_v6_to_v5"] = {"bytes_in": t["bytes_in"], "bytes_out": t["bytes_out"],
                                    "indices_equal": True}
    log(f"[tiers] checks {json.dumps(checks)}")
    return out, checks


def grown_codebook(tree, cfg, seed: int, k: int = 4096):
    """The flagship's 256 trained codes and k - 256 more, each a trained
    code (drawn with numpy from `seed`) plus Gaussian noise of 2% of the
    codebook's spread, so that codes above 255 win for about 1% of the
    latents of a smooth field (a tenth of the spread: almost none)."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(seed)
    vq = tree["vq"]
    e = np.asarray(vq["embedding"], np.float32)
    src = rng.integers(0, e.shape[0], k - e.shape[0])
    noise = rng.standard_normal((k - e.shape[0], e.shape[1])).astype(np.float32)
    big = np.concatenate([e, e[src] + 0.02 * e.std() * noise])
    grown = dict(tree, vq=dict(vq, embedding=big,
                               cluster_size=np.zeros(k, np.float32), embed_avg=big.copy()))
    return grown, dataclasses.replace(cfg, num_embeddings=k)


def large_codebook_phase(tree, cfg, grid, seed: int, workdir: Path):
    """Phase 11: the flagship grown to K=4096 through v4 (u16 indices), and
    the score kernel at F=64, K=4096 against its plain version."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    big_tree, big_cfg = grown_codebook(tree, cfg, seed)
    codec = VQCodec(big_tree, big_cfg, CodecConfig(), device="cuda")
    codec.compress(grid_subset(grid, 5000), workdir / "warm.vqvdb")
    torch.cuda.synchronize()
    res = round_trip("k4096", codec, grid, workdir, MIN_PSNR_DB)
    n, tiles = res["batches"], codec._score_prep.tiles
    expect_launches("k4096 encode", res["encode_launches"], score_argmin=n * tiles)
    expect_launches("k4096 decode", res["decode_launches"], dequantize=n)
    with VqvdbReader(workdir / "k4096.vqvdb") as r:
        version = r.version
    idx = _file_indices(workdir / "k4096.vqvdb")
    if version != 4 or idx.dtype != np.uint16 or not (idx > 255).any():
        raise AssertionError(f"k4096: v{version} file of {idx.dtype} indices, max {idx.max()}")
    res.update(file_version=version, tiles=tiles, index_dtype=str(idx.dtype),
               share_above_255=float((idx > 255).mean()), max_index=int(idx.max()))
    with torch.inference_mode():
        x = torch.from_numpy(grid.leaves[:4096]).cuda()
        h_bf16 = codec._features(x.to(torch.bfloat16)).reshape(-1, 64)
        h_f32 = codec._features(x).reshape(-1, 64)
        row = score_argmin_row("score_argmin_k4096", h_f32, h_bf16, *codec._score_mc)
    return res, row


def derived_model(seed: int, width: int, dim: int, k: int = 256):
    """A model of the flagship's graph (packed scalar encoder, scalar
    decoder) at encoder width `width` and latent depth `dim`, its weights
    drawn with numpy from `seed` (He-scaled convs, GroupNorm at identity, a
    Gaussian codebook): it takes the kernels to feature and latent depths
    that no shipped model has."""
    import dataclasses

    import numpy as np

    from vqvdb_tpu_torch.core.config import ModelConfig

    rng = np.random.default_rng(seed)

    def conv(kk, cin, cout):
        w = rng.standard_normal((kk, kk, kk, cin, cout)) * np.sqrt(2.0 / (kk ** 3 * cin))
        return {"w": w.astype(np.float32), "b": np.zeros(cout, np.float32)}

    def gn(ch):
        return {"scale": np.ones(ch, np.float32), "bias": np.zeros(ch, np.float32)}

    def rb(ch):
        return {"conv1": conv(3, ch, ch), "conv2": conv(3, ch, ch), "gn1": gn(ch), "gn2": gn(ch)}

    def attn(ch):
        hid = max(ch // 4, 1)
        return {"fc1": {"w": (rng.standard_normal((ch, hid)) / np.sqrt(ch)).astype(np.float32)},
                "fc2": {"w": (rng.standard_normal((hid, ch)) / np.sqrt(hid)).astype(np.float32)}}

    proj = conv(1, width, dim)
    proj["w"] *= np.float32(np.sqrt(0.5))
    codebook = rng.standard_normal((k, dim)).astype(np.float32)
    tree = {
        "encoder": {"stem_conv": conv(3, 8, width), "stem_gn": gn(width), "rb": rb(width),
                    "attn": attn(width), "proj": proj},
        "decoder": {"stem_conv": conv(3, dim, 64), "stem_gn": gn(64), "rb": rb(64),
                    "attn": attn(64), "up_conv": conv(3, 64, 256), "final": conv(3, 32, 1)},
        "vq": {"embedding": codebook, "cluster_size": np.zeros(k, np.float32),
               "embed_avg": codebook.copy()},
    }
    cfg = dataclasses.replace(ModelConfig(), embedding_dim=dim, num_embeddings=k,
                              encoder_arch="packed")
    return tree, cfg


def deep_rows_phase(seed: int, grid, workdir: Path):
    """Phase 13: the kernels at depths and row widths that no shipped model
    reaches, each on a path of a derived model (`derived_model`), counters
    reset just before the path and read just after:
      deep160 (encoder width 160, latent depth 160, f32): compress, the
        score kernel on f32 rows of depth 160 (streamed depth); unfused,
        the nearest-code kernel at D = 160 (streamed depth);
      wide1024 (encoder width 1024, bf16): compress, the score kernel on
        bf16 rows of depth 1024 (streamed depth);
      d20 (latent depth 20, bf16): decompress, the dequantize kernel on
        40-byte bf16 codebook rows (8-byte vectors).
    Then each kernel against its plain version on the path's own inputs."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.models.vqvae import encoder_apply
    from vqvdb_tpu_torch.ops import quantize as q
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    data = grid_subset(grid, 2 * 4096 + 123)
    res, codecs = {}, {}
    for label, width, dim, opts, leaves, kernel in (
            ("deep160", 160, 160, dict(compute_dtype="float32"), data, "score_argmin"),
            ("deep160_unfused", 160, 160,
             dict(compute_dtype="float32", fuse_proj_quantize=False), data, "nearest_indices"),
            ("wide1024", 1024, 128, {}, grid_subset(grid, 4096), "score_argmin"),
            ("d20", 64, 20, {}, data, "score_argmin")):
        tree, cfg = derived_model(seed + width + dim, width, dim)
        codec = VQCodec(tree, cfg, CodecConfig(**opts), device="cuda")
        batches = -(-leaves.num_leaves // codec.ccfg.batch_size)
        want = {kernel: batches}
        path = workdir / f"{label}.vqvdb"
        codec.compress(grid_subset(leaves, 64), path)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stats = codec.compress(leaves, path)
        enc = read_launches()
        expect_launches(f"{label} compress", enc, **want)
        reset_launches()
        out, dstats = codec.decompress(path)
        dec = read_launches()
        expect_launches(f"{label} decompress", dec, dequantize=batches)
        if (out[0].leaves.shape != leaves.leaves.shape or not np.isfinite(out[0].leaves).all()
                or not np.array_equal(out[0].origins, leaves.origins)):
            raise AssertionError(f"{label}: decoded leaves or origins are not the input's")
        res[label] = {"width": width, "dim": dim, "leaves": leaves.num_leaves,
                      "compress_leaves_per_s": stats["leaves_per_sec"],
                      "decompress_leaves_per_s": dstats["leaves_per_sec"],
                      "seconds": time.perf_counter() - t0,
                      "encode_launches": enc, "decode_launches": dec}
        codecs[label] = codec
    rows = []
    with torch.inference_mode():
        x = torch.from_numpy(grid.leaves[:4096]).cuda()
        for name, label in (("score_argmin_f32_d160", "deep160"),
                            ("score_argmin_bf16_d1024", "wide1024")):
            codec = codecs[label]
            h_f32 = codec._features(x)
            h_bf16 = codec._features(x.to(torch.bfloat16))
            f = h_f32.shape[-1]
            rows.append(score_argmin_row(
                name, h_f32.reshape(-1, f), h_bf16.reshape(-1, f), *codec._score_mc,
                timed=h_f32.reshape(-1, f) if label == "deep160" else None))
        codec = codecs["deep160_unfused"]
        z = encoder_apply(codec.params["encoder"], x, codec.mcfg).reshape(-1, 160).float()
        rows.append(nearest_row("nearest_d160", z, codec.params["vq"]["embedding"]))
        codec = codecs["d20"]
        idx = codec._encode_step(x).reshape(-1)
        rows.append(dequantize_row("dequantize_bf16_d20", idx, codec.params["vq"]["embedding"]))
    plans = {name: q.score_plan(depth, 256, size).mode for name, depth, size in
             (("f32_d160", 160, 4), ("bf16_d1024", 1024, 2), ("nearest_d160", 160, 4))}
    res["score_plans"] = plans
    if set(plans.values()) != {"streamed"}:
        raise AssertionError(f"deep rows did not take the streamed-depth mode: {plans}")
    return res, rows


def _cli(argv):
    """vqvdb_tpu_torch.cli.main(argv) -> (exit code, its last JSON line)."""
    import contextlib
    import io

    from vqvdb_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _by_origin(grid):
    """(origins, leaves) in lexicographic origin order."""
    import numpy as np

    order = np.lexsort(grid.origins.T[::-1])
    return grid.origins[order], grid.leaves[order]


def user_path(codec, grid, workdir: Path):
    """Phase 12: the user's file path at full width on the flagship:
    .vdb -> CLI encode (and --streaming) -> .vqvdb -> CLI decode -> .vdb;
    dense decode on the device of a v3 and a v6-int8 file; encode from the
    dense device tensor. Counters reset around each dense path; rates of the
    dense and the sparse paths in turns."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.format.verify import verify_roundtrip
    from vqvdb_tpu_torch.vdb.grid import LeafGrid, psnr
    from vqvdb_tpu_torch.vdb.openvdb_io import read_vdb_leafgrids, write_vdb_leafgrids

    model = REPO / "models" / "scalar.vqmodel"
    out = {"leaves": grid.num_leaves}
    vdb = workdir / "scene.vdb"
    t0 = time.perf_counter()
    write_vdb_leafgrids(vdb, [grid])
    t1 = time.perf_counter()
    (from_vdb,) = read_vdb_leafgrids(vdb)
    out["vdb_write_s"], out["vdb_read_s"] = t1 - t0, time.perf_counter() - t1
    out["vdb_bytes"] = vdb.stat().st_size
    # 1-3: CLI encode, plain and streamed, against compress of what the .vdb holds
    ref = workdir / "ref.vqvdb"
    codec.compress(from_vdb, ref)
    for label, extra in (("cli_encode", []), ("cli_encode_streaming", ["--streaming"])):
        path = workdir / f"{label}.vqvdb"
        t0 = time.perf_counter()
        rc, stats = _cli(["encode", vdb, path, "--model", model, *extra])
        wall = time.perf_counter() - t0
        if rc != 0 or path.read_bytes() != ref.read_bytes():
            raise AssertionError(f"{label}: exit {rc}, file equal to compress: "
                                 f"{rc == 0 and path.read_bytes() == ref.read_bytes()}")
        out[label] = {"leaves_per_s": stats["leaves_per_sec"], "wall_s": wall,
                      "host_seconds": stats["host_seconds"], "byte_identical": True}
    # 4: CLI decode to .vdb, read back
    recon_vdb = workdir / "recon.vdb"
    t0 = time.perf_counter()
    rc, stats = _cli(["decode", ref, recon_vdb, "--model", model])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli decode: exit {rc}")
    (recon,) = read_vdb_leafgrids(recon_vdb)
    sparse, _ = codec.decompress(ref)
    ro, rl = _by_origin(recon)
    so, sl = _by_origin(sparse[0])
    go, gl = _by_origin(grid)
    if not (np.array_equal(ro, so) and np.array_equal(rl, sl) and np.array_equal(ro, go)):
        raise AssertionError("cli decode: the .vdb differs from decompress")
    quality = psnr(rl, gl)
    if not quality > MIN_PSNR_DB:
        raise AssertionError(f"cli decode: PSNR {quality:.2f} dB <= {MIN_PSNR_DB}")
    out["cli_decode"] = {"leaves_per_s": stats["leaves_per_sec"], "wall_s": wall,
                         "host_seconds": stats["host_seconds"], "psnr_db": quality,
                         "equal_to_decompress": True}
    # 5: dense decode of the v3 file and of a v6-int8 file
    v6 = workdir / "v6.vqvdb"
    codec.compress(grid, v6, residual="int8")
    batches = -(-grid.num_leaves // codec.ccfg.batch_size)
    checks = {}
    for label, path in (("v3", ref), ("v6_int8", v6)):
        reset_launches()
        (res,) = api.decode_dense(path, codec)
        torch.cuda.synchronize()
        expect_launches(f"dense decode {label}", read_launches(), dequantize=batches)
        dense = res["dense"]
        if not dense.is_cuda:
            raise AssertionError(f"dense decode {label}: result on {dense.device}")
        host, host_lo = codec.decompress(path)[0][0].to_dense()
        got = dense.cpu().numpy()
        if not (np.array_equal(got, host) and np.array_equal(res["lo"], host_lo)):
            raise AssertionError(f"dense decode {label}: differs from decompress + to_dense")
        checks[label] = {"shape": list(dense.shape), "bit_equal_to_sparse": True}
        if label == "v6_int8":
            report = verify_roundtrip(path, codec, [grid])
            bound = report["grids"][0]["residual_bound"]
            src, _ = grid.to_dense()
            err = float(np.abs(got - src).max())
            if not (report["ok"] and report["grids"][0]["bound_ok"] and err <= bound):
                raise AssertionError(f"dense v6 int8: max error {err} against bound {bound}")
            checks[label].update(max_abs_err=err, bound=bound, bound_ok=True)
        else:
            v3_dense, lo = dense, res["lo"]
    del dense, res
    # 6: encode from the dense tensor on the card
    from_dense = LeafGrid.from_dense("density", v3_dense.cpu().numpy(), origin=lo)
    want = workdir / "from_dense.vqvdb"
    codec.compress(from_dense, want)
    got = workdir / "encode_dense.vqvdb"
    reset_launches()
    stats = api.encode_dense(v3_dense, codec, got, origin=lo)
    expect_launches("dense encode", read_launches(),
                    score_argmin=-(-from_dense.num_leaves // codec.ccfg.batch_size))
    if got.read_bytes() != want.read_bytes():
        raise AssertionError("encode_dense differs from compress(LeafGrid.from_dense)")
    checks["encode_dense"] = {"leaves": stats["leaves"], "byte_identical": True}
    out["checks"] = checks
    # 8: rates in turns on this card: sparse, dense, dense, sparse
    n, m = grid.num_leaves, from_dense.num_leaves
    rates = {k: [] for k in ("decompress", "decompress_to_dense", "dense_decode",
                             "compress", "encode_dense")}
    for turn in ("sparse", "dense", "dense", "sparse"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn == "sparse":
            grids, _ = codec.decompress(ref)
            t1 = time.perf_counter()
            grids[0].to_dense()
            rates["decompress"].append(n / (t1 - t0))
            rates["decompress_to_dense"].append(n / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            codec.compress(from_dense, want)
            rates["compress"].append(m / (time.perf_counter() - t0))
        else:
            (res,) = api.decode_dense(ref, codec)
            torch.cuda.synchronize()
            rates["dense_decode"].append(n / (time.perf_counter() - t0))
            del res
            t0 = time.perf_counter()
            api.encode_dense(v3_dense, codec, got, origin=lo)
            rates["encode_dense"].append(m / (time.perf_counter() - t0))
    out["leaves_per_s_in_turns"] = rates
    return out


# ---------------------------------------------------------------------------
# Phase 14: training
# ---------------------------------------------------------------------------

TRAIN_GRAD_TOL = 1e-4  # card vs CPU gradient entries, of the tree's largest entry
TRAIN_EMA_RTOL = 1e-5  # card vs CPU EMA statistics off near-tie codes
FAST_TOL = 1e-5  # fast path vs host loop over its permutation (trace and params)


def _quiet(*_):
    pass


def _adam_check(label, got, want, steps, lr):
    """Params after `steps` Adam steps: per leaf at most 1% of the entries
    more than 1e-2 * steps * lr apart and none more than 2 * steps * lr
    (a gradient entry within rounding of zero takes a +-lr step). Returns
    the largest difference."""
    import torch

    worst = 0.0
    for a, b in zip(got, want):
        d = (a.double().cpu() - b.double().cpu()).abs()
        worst = max(worst, d.max().item())
        if d.max().item() > 2 * steps * lr or (d > 1e-2 * steps * lr).double().mean() > 0.01:
            raise AssertionError(f"{label}: params differ beyond the Adam-step tolerance "
                                 f"(max {d.max().item():.3g}, lr {lr})")
    return worst


def _near_tie_codes(z, emb):
    """Codes that rows of z [N, D] nearly tie between, on the f64 distances."""
    z64, e64 = z.double(), emb.double()
    d = (e64 * e64).sum(1)[None, :] - 2.0 * (z64 @ e64.T)
    two = d.topk(2, dim=1, largest=False)
    tie = (two.values[:, 1] - two.values[:, 0]) < NEAR_TIE_REL * two.values[:, 0].abs().clamp(min=1.0)
    return set(two.indices[tie].flatten().tolist())


def _step_with_grads(state, batch, opt, cfg, tcfg):
    """train_step's arithmetic with its gradients kept: (grads, new param
    leaves, new VQState, metrics, z)."""
    import torch

    from vqvdb_tpu_torch.models.quantizer import VQState
    from vqvdb_tpu_torch.train import train as T

    trainable = T.tree_map(lambda t: t.detach().requires_grad_(), T._trainable(state.params))
    leaves = T.tree_leaves(trainable)
    loss, (new_vq, metrics, z) = T._forward_loss(trainable, VQState(**state.params["vq"]),
                                                 batch, cfg, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new_leaves, _ = opt.update(list(grads), state.opt_state, [t.detach() for t in leaves])
    return grads, new_leaves, new_vq, {k: v.detach() for k, v in metrics.items()}, z.detach()


def train_card_vs_cpu(cfg, leaves, seed, dev):
    """Step 14.1: one f32 train step (TF32 off) from the same params on the
    card and on the CPU: gradients, params after the step, EMA state."""
    import torch

    from vqvdb_tpu_torch.models.blocks import no_tf32
    from vqvdb_tpu_torch.train import train as T

    tcfg = T.TrainConfig(compute_dtype="float32", batch_size=leaves.shape[0], seed=seed)
    opt = T.make_optimizer(tcfg, 10)
    out = {}
    for d in (dev, torch.device("cpu")):
        state = T.make_train_state(cfg, tcfg, 10, d)
        with no_tf32(d):
            out[d.type] = _step_with_grads(state, torch.from_numpy(leaves).to(d), opt, cfg, tcfg)
    (g_card, p_card, vq_card, m_card, z_card), (g_cpu, p_cpu, vq_cpu, m_cpu, z_cpu) = \
        out[dev.type], out["cpu"]
    scale = max(g.abs().max().item() for g in g_cpu)
    grad_err = max((a.cpu() - b).abs().max().item() for a, b in zip(g_card, g_cpu))
    if not grad_err <= TRAIN_GRAD_TOL * scale:
        raise AssertionError(f"train step card vs cpu: gradients differ by {grad_err:.3g}, "
                             f"> {TRAIN_GRAD_TOL} x {scale:.3g}")
    param_err = _adam_check("train step card vs cpu", p_card, p_cpu, 1, tcfg.lr)
    emb0 = T.make_train_state(cfg, tcfg, 10, "cpu").params["vq"]["embedding"]
    ties = _near_tie_codes(z_cpu.reshape(-1, cfg.embedding_dim), emb0)
    keep = torch.ones(cfg.num_embeddings, dtype=torch.bool)
    keep[list(ties)] = False
    ema_err = 0.0
    for a, b in zip(vq_card, vq_cpu):
        a, b = a.cpu()[keep], b[keep]
        err = ((a - b).abs() / b.abs().clamp(min=1e-3)).max().item()
        ema_err = max(ema_err, err)
    if not ema_err <= TRAIN_EMA_RTOL:
        raise AssertionError(f"train step card vs cpu: EMA state differs by {ema_err:.3g} "
                             f"relative off {len(ties)} near-tie codes")
    loss_err = max(abs(float(m_card[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-12)
                   for k in m_cpu)
    return {"leaves": leaves.shape[0], "grad_max_abs_err": grad_err, "grad_scale": scale,
            "grad_tol": TRAIN_GRAD_TOL, "param_max_abs_err": param_err, "lr": tcfg.lr,
            "ema_max_rel_err": ema_err, "near_tie_codes": len(ties),
            "metric_max_rel_err": loss_err}


def _split_counts(n_leaves, tcfg):
    n_val = int(n_leaves * tcfg.val_fraction)
    return (n_leaves - n_val) // tcfg.batch_size, n_val // tcfg.batch_size


def train_host_loop(cfg, tcfg, pool_path, dev):
    """Step 14.2: the host loop (`train`) over the pool's npy file, counters
    around it: one nearest-code and one dequantize launch per train step and
    per val batch; the epochs' recon loss falls."""
    import torch

    from vqvdb_tpu_torch.train import train as T
    from vqvdb_tpu_torch.train.data import LeafDataset

    ds = LeafDataset([pool_path])
    steps, vals = _split_counts(len(ds), tcfg)
    reset_launches()
    t0 = time.perf_counter()
    state, hist = T.train(ds, cfg, tcfg, device=dev, log_fn=_quiet)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    wall = time.perf_counter() - t0
    n = tcfg.epochs * (steps + vals)
    expect_launches("train host loop", read_launches(), nearest_indices=n, dequantize=n)
    recon = hist["train_recon"]
    if not all(map(lambda v: v == v and abs(v) < float("inf"), recon + hist["val_loss"])):
        raise AssertionError(f"train host loop: a loss is not finite: {hist}")
    if not recon[-1] < recon[0]:
        raise AssertionError(f"train host loop: recon loss did not fall: {recon}")
    return state, {"epochs": tcfg.epochs, "steps": tcfg.epochs * steps,
                   "val_batches": tcfg.epochs * vals, "wall_s": wall, "history": hist,
                   "launches": {"nearest_indices": n, "dequantize": n}}


def train_fast_path(cfg, tcfg, pool, dev):
    """Step 14.3: `train_on_device` over the resident pool, counters around
    it; then the host loop over the same split and permutations (batches
    gathered on the host and uploaded), with cuDNN deterministic for both:
    the metrics trace and params within FAST_TOL. Then one resident epoch
    under CUDA sync debugging set to raise: no step waits for the device."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.train import train as T
    from vqvdb_tpu_torch.train.fast import epoch_permutation, run_epochs, train_on_device

    steps, vals = _split_counts(pool.shape[0], tcfg)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                     allow_tf32=cudnn.allow_tf32):
        reset_launches()
        state, trace = train_on_device(pool, cfg, tcfg, device=dev, log_fn=_quiet)
        launches = read_launches()
        n = tcfg.epochs * (steps + vals)
        expect_launches("train fast path", launches, nearest_indices=n, dequantize=n)
        split = np.random.default_rng(tcfg.seed).permutation(pool.shape[0])
        n_val = int(pool.shape[0] * tcfg.val_fraction)
        train_np, val_np = pool[split[n_val:]], pool[split[:n_val]]
        bs = tcfg.batch_size
        opt = T.make_optimizer(tcfg, steps * tcfg.epochs)
        ref = T.make_train_state(cfg, tcfg, steps * tcfg.epochs, dev)
        rows = []
        for e in range(tcfg.epochs):
            perm = epoch_permutation(tcfg, train_np.shape[0], e, dev).cpu().numpy()
            acc = []
            for i in range(steps):
                batch = torch.from_numpy(train_np[perm[i * bs:(i + 1) * bs]]).to(dev)
                ref, m, _ = T.train_step(ref, batch, opt, cfg, tcfg)
                acc.append(torch.stack([m[k].float() for k in
                                        ("loss", "recon_err", "vq_loss", "perplexity")]))
            val = torch.stack([T.eval_step(ref.params, torch.from_numpy(
                val_np[i * bs:(i + 1) * bs]).to(dev), cfg, tcfg)["loss"].float()
                for i in range(vals)]).mean()
            rows.append(torch.cat([torch.stack(acc).mean(0), val[None]]).cpu().numpy())
    trace_err = float(np.abs(trace - np.array(rows)).max() / np.abs(np.array(rows)).max())
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(T.tree_leaves(state.params), T.tree_leaves(ref.params)))
    if not (trace_err <= FAST_TOL and param_err <= FAST_TOL):
        raise AssertionError(f"train fast path vs host loop: trace {trace_err:.3g}, params "
                             f"{param_err:.3g} > {FAST_TOL}")
    if not np.isfinite(trace).all():
        raise AssertionError(f"train fast path: metrics not finite: {trace}")
    syncs = "not checked on the CPU"
    if dev.type == "cuda":
        # An epoch of resident steps and validation must not wait for the
        # device: PyTorch raises on any synchronising call in this mode.
        data = torch.from_numpy(train_np).to(dev)
        val_data = torch.from_numpy(val_np).to(dev)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_epochs(state, data, val_data, opt, cfg, tcfg, 0, 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = 0
    return state, {"epochs": tcfg.epochs, "steps": tcfg.epochs * steps,
                   "launches": launches, "trace": trace.tolist(),
                   "host_syncs_in_an_epoch": syncs,
                   "vs_host_loop": {"trace_max_rel_err": trace_err,
                                    "param_max_abs_err": param_err,
                                    "bitwise": param_err == 0.0}}


def train_resume(cfg, tcfg, pool, dev, workdir: Path):
    """Step 14.4: train with a checkpoint (and a dead-code reset) after each
    epoch; again, drop the last checkpoint and resume: the params of the two
    runs, bit for bit under cuDNN's deterministic mode, else within FAST_TOL
    with the reason logged."""
    import shutil

    import torch

    from vqvdb_tpu_torch.train import train as T
    from vqvdb_tpu_torch.train.checkpoint import CheckpointManager
    from vqvdb_tpu_torch.train.fast import train_on_device

    tcfg = dataclasses.replace(tcfg, dead_code_interval=1)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                     allow_tf32=cudnn.allow_tf32):
        full, _ = train_on_device(pool, cfg, tcfg, device=dev, log_fn=_quiet,
                                  checkpoint_dir=str(workdir / "ckpt_a"))
        train_on_device(pool, cfg, tcfg, device=dev, log_fn=_quiet,
                        checkpoint_dir=str(workdir / "ckpt_b"))
        manager = CheckpointManager(workdir / "ckpt_b")
        steps = manager.all_steps()
        shutil.rmtree(workdir / "ckpt_b" / f"step_{steps[-1]:010d}")
        logs = []
        resumed, _ = train_on_device(pool, cfg, tcfg, device=dev, log_fn=logs.append,
                                     checkpoint_dir=str(workdir / "ckpt_b"))
    if not any("resumed at epoch" in line for line in logs):
        raise AssertionError(f"train resume: the run did not resume: {logs}")
    pairs = list(zip(T.tree_leaves(resumed.params), T.tree_leaves(full.params)))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    err = max((a - b).abs().max().item() for a, b in pairs)
    if resumed.step != full.step or not err <= FAST_TOL:
        raise AssertionError(f"train resume: step {resumed.step} vs {full.step}, params "
                             f"differ by {err:.3g}")
    out = {"checkpoints": steps, "bitwise": bitwise, "param_max_abs_err": err}
    if not bitwise:
        out["reason"] = ("not bit for bit although cuDNN ran deterministic: an op outside "
                         "cuDNN summed in another order")
    return out


def train_codec(cfg, params, grid, seed, workdir: Path):
    """Step 14.5: the trained params -> save_model -> load_model -> VQCodec
    (default CodecConfig): v3 round trip of the phase-3 field with the
    counters around each half, then evaluate_codec / codebook_report on 16,384
    leaves; the trained model must beat its own initial params there."""
    from vqvdb_tpu_torch.core.artifact import load_model, save_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.eval.metrics import codebook_report, evaluate_codec
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.train import train as T

    path = workdir / "trained.vqmodel"
    save_model(path, params, cfg)
    tree, cfg2 = load_model(path)
    if cfg2 != cfg:
        raise AssertionError(f"trained model: config {cfg2} read back as {cfg}")
    codec = VQCodec(tree, cfg2, CodecConfig(), device="cuda")
    res = round_trip("trained", codec, grid, workdir, min_psnr=0.0)
    n = res["batches"]
    expect_launches("trained model encode", res["encode_launches"], score_argmin=n)
    expect_launches("trained model decode", res["decode_launches"], dequantize=n)
    sample = grid.leaves[:16384]
    report = evaluate_codec(codec, sample)
    book = codebook_report(report["indices"], cfg.num_embeddings)
    init = T.make_train_state(cfg, T.TrainConfig(seed=seed), 1, "cpu").params
    save_model(workdir / "init.vqmodel", init, cfg)
    base = evaluate_codec(VQCodec(*load_model(workdir / "init.vqmodel"), CodecConfig(),
                                  device="cuda"), sample)
    if not report["psnr_mean"] > base["psnr_mean"]:
        raise AssertionError(f"trained model: PSNR {report['psnr_mean']:.2f} dB does not "
                             f"beat its initial params' {base['psnr_mean']:.2f} dB")
    return {"round_trip": res, "eval": {k: v for k, v in report.items()
                                        if not hasattr(v, "shape")},
            "init_psnr_mean": base["psnr_mean"], "perplexity": book["perplexity"],
            "active_codes": book["active_codes"], "dead_codes": book["dead_codes"]}


def train_other_archs(tcfg, pool, dev):
    """Step 14.6: two steps of the reference arch (the CLI's default
    --encoder-arch) and of scalar_rvq2's config (two nearest-code and two
    dequantize launches a step)."""
    import math

    import torch

    from vqvdb_tpu_torch.core.artifact import load_model_config
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.train import train as T

    out = {}
    for label, cfg in (("reference", ModelConfig()),
                       ("scalar_rvq2", load_model_config(REPO / "models" / "scalar_rvq2.vqmodel"))):
        opt = T.make_optimizer(tcfg, 2)
        state = T.make_train_state(cfg, tcfg, 2, dev)
        reset_launches()
        losses = []
        for i in range(2):
            batch = torch.from_numpy(pool[i * tcfg.batch_size:(i + 1) * tcfg.batch_size]).to(dev)
            state, m, _ = T.train_step(state, batch, opt, cfg, tcfg)
            losses.append(float(m["loss"]))
        launches = read_launches()
        s = cfg.num_quantizers
        expect_launches(f"train {label}", launches, nearest_indices=2 * s, dequantize=2 * s)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train {label}: losses {losses}")
        out[label] = {"losses": losses, "launches": launches}
    return out


def train_rates(cfg, tcfg, pool, pool_path, dev):
    """Step 14.7: one epoch of the host loop and of the fast path, in turns
    (host, fast, fast, host): steps/s and leaves/s of the whole epoch (train
    steps, the val batches, the host's data handling)."""
    import torch

    from vqvdb_tpu_torch.train import train as T
    from vqvdb_tpu_torch.train.data import LeafDataset
    from vqvdb_tpu_torch.train.fast import train_on_device

    one = dataclasses.replace(tcfg, epochs=1)
    steps, vals = _split_counts(pool.shape[0], one)
    ds = LeafDataset([pool_path])
    runs = {"host": lambda: T.train(ds, cfg, one, device=dev, log_fn=_quiet),
            "fast": lambda: train_on_device(pool, cfg, one, device=dev, log_fn=_quiet)}
    out = {"steps": steps, "val_batches": vals, "batch": one.batch_size}
    for name in ("host", "fast", "fast", "host"):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        out.setdefault(name, []).append({"wall_s": wall, "steps_per_s": steps / wall,
                                         "leaves_per_s": steps * one.batch_size / wall})
    return out


def profile_train_step(cfg, tcfg, pool, dev, out_dir: Path):
    """--profile: torch.profiler over one steady train step; the table goes to
    out_dir/profile_train_step.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vqvdb_tpu_torch.train import train as T

    opt = T.make_optimizer(tcfg, 10)
    state = T.make_train_state(cfg, tcfg, 10, dev)
    batch = torch.from_numpy(pool[:tcfg.batch_size]).to(dev)
    for _ in range(3):
        state, _, _ = T.train_step(state, batch, opt, cfg, tcfg)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.train_step(state, batch, opt, cfg, tcfg)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    (out_dir / "profile_train_step.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=30))
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    dev_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall * 1e3, "device_ms": dev_ms,
            "idle_share": max(0.0, 1 - dev_ms / (wall * 1e3)),
            "kernels": len(kernels), "top": [[name[:80], ms] for name, ms in top]}


def train_kernel_rows(cfg, params, pool, tcfg, dev):
    """The nearest-code and dequantize kernels at a train step's shapes: the
    encoder outputs of one batch in the compute dtype, as f32 rows against
    the trained codebook (prepared anew each call, as a step does), and
    their int32 codes looked up in the codebook cast to the compute dtype."""
    import torch

    from vqvdb_tpu_torch.models.quantizer import dequantize
    from vqvdb_tpu_torch.models.vqvae import encoder_apply
    from vqvdb_tpu_torch.ops import quantize as q

    emb = params["vq"]["embedding"]
    with torch.inference_mode():
        x = torch.from_numpy(pool[:tcfg.batch_size]).to(dev, getattr(torch, tcfg.compute_dtype))
        z = encoder_apply(params["encoder"], x, cfg).reshape(-1, cfg.embedding_dim).float()
        near = nearest_row("nearest_indices_train", z, emb, prepared=False)
        idx = q.fused_nearest_indices(z, emb)
        cb = emb.to(x.dtype)
        got = q.fused_dequantize(idx, cb)
        if not torch.equal(got, dequantize(idx, cb)):
            raise AssertionError("dequantize_train: kernel rows differ from plain")
        n, d = idx.shape[0], cb.shape[1]
        nbytes = n * 4 + cb.numel() * cb.element_size() + n * d * cb.element_size()
        idx_lib = idx.long()
        deq = dict(
            name="dequantize_train", route="cuda", source="vqvdb_tpu_torch/csrc/dequantize.cu",
            replaces="vqvdb_tpu/ops/quantize.py:110", max_abs_err=0.0,
            ms=cuda_ms(lambda: q.fused_dequantize(idx, cb), graph=True),
            plain_ms=cuda_ms(lambda: dequantize(idx, cb)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=cuda_ms(lambda: cb.index_select(0, idx_lib)),
            check=f"train step: {n} int32 codes, D={d} {cb.dtype} rows, bit-equal")
    return [near, deq]


def train_phase(args, cfg, grid, workdir: Path, dev=None, tcfg=None, cpu_leaves: int = 256):
    """Phase 14: the flagship's training at full width: steps 14.1-14.7 (see
    the module docstring), each logged as `[train] <step> {...}`. Returns
    (results, the two kernel rows at a train step's shapes)."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.train import train as T

    dev = dev or torch.device("cuda")
    tcfg = tcfg or T.TrainConfig(epochs=2, seed=args.seed)
    pool = grid.leaves
    pool_path = workdir / "pool.npy"
    np.save(pool_path, pool[..., 0])
    res = {}

    def step(name, value):
        res[name] = value
        log(f"[train] {name} {json.dumps(value)}")

    step("card_vs_cpu", train_card_vs_cpu(cfg, pool[:cpu_leaves], args.seed, dev))
    step("host_loop", train_host_loop(cfg, tcfg, pool_path, dev)[1])
    state, fast = train_fast_path(cfg, tcfg, pool, dev)
    step("fast_path", fast)
    step("resume", train_resume(cfg, tcfg, pool, dev, workdir))
    step("codec", train_codec(cfg, state.params, grid, args.seed, workdir))
    step("archs", train_other_archs(tcfg, pool, dev))
    step("rates", train_rates(cfg, tcfg, pool, pool_path, dev))
    if args.profile is not None:
        step("profile", profile_train_step(cfg, tcfg, pool, dev, args.profile))
    rows = train_kernel_rows(cfg, state.params, pool, tcfg, dev) if dev.type == "cuda" else []
    return res, rows


# ---------------------------------------------------------------------------
# Phase 15: serving and interop
# ---------------------------------------------------------------------------

SERVE_CLIENTS = 32
SERVE_REQUESTS = 8  # per client
SERVE_LEAVES = (256, 1024)  # leaves per /encode_leaves request, inclusive
SERVE_FILE_LEAVES = 16384  # the /encode .npy


def _http(addr, method, path, body=None):
    """One request on its own connection: (status, body bytes)."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _npy_bytes(arr) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _traffic(addr, path, bodies, clients: int, stray=None):
    """POST bodies[c][r] to `path` from `clients` threads (client c sends its
    row of bodies one after another; with clients=1 one thread sends them
    all in turn). `stray` is one more (path, body) sent from its own thread
    while the others are in flight. Returns (answers [c][r] as (status,
    bytes), per-request latencies in s, wall s, the stray's answer)."""
    import threading

    if clients == 1:
        bodies = [[b for row in bodies for b in row]]
    answers = [[None] * len(row) for row in bodies]
    lat = [[0.0] * len(row) for row in bodies]
    stray_answer = []
    gate = threading.Barrier(len(bodies) + (stray is not None))

    def client(c):
        gate.wait()
        for r, body in enumerate(bodies[c]):
            t0 = time.perf_counter()
            answers[c][r] = _http(addr, "POST", path, body)
            lat[c][r] = time.perf_counter() - t0

    def send_stray():
        gate.wait()
        time.sleep(0.005)
        stray_answer.append(_http(addr, "POST", *stray))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(bodies))]
    if stray is not None:
        threads.append(threading.Thread(target=send_stray))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{path}: a client did not finish")
    flat = [a for row in answers for a in row]
    bad = [a for a in flat if a[0] != 200]
    if bad:
        raise AssertionError(f"{path}: {len(bad)} requests failed, first {bad[0][0]} "
                             f"{bad[0][1][:200]!r}")
    if clients == 1:
        answers = [flat[i: i + SERVE_REQUESTS] for i in range(0, len(flat), SERVE_REQUESTS)]
        lat = [lat[0][i: i + SERVE_REQUESTS] for i in range(0, len(flat), SERVE_REQUESTS)]
    return answers, [x for row in lat for x in row], wall, stray_answer[0] if stray else None


def _window_rates(n_requests, n_leaves, lat, wall):
    import numpy as np

    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    return {"requests_per_s": n_requests / wall, "leaves_per_s": n_leaves / wall,
            "p50_ms": float(p50), "p99_ms": float(p99), "wall_s": wall}


def serving_phase(seed: int, grid, workdir: Path, device: str = "cuda"):
    """Phase 15.1: the flagship served by `serving.py` on 127.0.0.1:0 (batch
    4096, bf16): 32 clients x 8 /encode_leaves requests of 256-1024 leaves
    cut from the field, a malformed request among them, then a
    /decode_indices request for each answer; an /encode of a 16,384-leaf .npy
    and a /decode of its file; /healthz and /stats. Gates: every answer equals
    the codec's own call on the same rows; the file is compress's, its decode
    decompress's; the malformed request alone fails (400); requests coalesce;
    one score-argmin launch per encode batch and one dequantize launch per
    decode batch. Then the same traffic from one client, in turns
    (concurrent, serial, serial, concurrent)."""
    import io
    import threading

    import numpy as np

    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.serving import CodecService, make_server

    codec = api.make_codec(REPO / "models" / "scalar.vqmodel", device=device)
    service = CodecService(codec)
    srv = make_server(service, "127.0.0.1", 0)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    addr = srv.server_address
    rng = np.random.default_rng(seed + 15)
    sizes = rng.integers(SERVE_LEAVES[0], SERVE_LEAVES[1] + 1, (SERVE_CLIENTS, SERVE_REQUESTS))
    starts = rng.integers(0, grid.num_leaves - SERVE_LEAVES[1], sizes.shape)
    rows = [[grid.leaves[a: a + n] for a, n in zip(sa, sn)] for sa, sn in zip(starts, sizes)]
    enc_bodies = [[_npy_bytes(x) for x in row] for row in rows]
    n_req, n_leaves = sizes.size, int(sizes.sum())
    malformed = ("/encode_leaves", _npy_bytes(np.zeros((300, 8, 8, 8, 3), np.float32)))
    out = {"clients": SERVE_CLIENTS, "requests_per_client": SERVE_REQUESTS,
           "leaves_per_request": list(SERVE_LEAVES), "requests": n_req, "leaves": n_leaves}

    def counts():
        mb = service.stats()["microbatch"]
        return (codec.profiler.report().get("device/dispatch", {}).get("count", 0),
                mb["encode"]["steps"], mb["encode"]["coalesced"],
                mb["decode"]["steps"], mb["decode"]["coalesced"])

    def window(path, bodies, clients, stray=None):
        before = counts()
        reset_launches()
        answers, lat, wall, stray_answer = _traffic(addr, path, bodies, clients, stray)
        launches = read_launches()
        after = counts()
        side = 1 if path == "/encode_leaves" else 3
        info = {"device_batches": after[0] - before[0], "steps": after[side] - before[side],
                "coalesced": after[side + 1] - before[side + 1], "launches": launches,
                **_window_rates(n_req, n_leaves, lat, wall)}
        return answers, info, stray_answer

    try:
        status, body = _http(addr, "GET", "/healthz")
        out["healthz"] = json.loads(body)
        if status != 200 or out["healthz"]["status"] != "ok":
            raise AssertionError(f"/healthz: {status} {body!r}")
        errors0 = service.stats()["counters"]["errors"]
        turns = {"concurrent": [], "serial": []}
        for turn_no, turn in enumerate(("concurrent", "serial", "serial", "concurrent")):
            clients = SERVE_CLIENTS if turn == "concurrent" else 1
            gated = turn_no == 0
            enc, enc_info, stray = window("/encode_leaves", enc_bodies, clients,
                                          malformed if gated else None)
            dec_bodies = [[_npy_bytes(np.load(io.BytesIO(a[1]))) for a in row] for row in enc]
            dec, dec_info, _ = window("/decode_indices", dec_bodies, clients)
            turns[turn].append({"encode": enc_info, "decode": dec_info})
            if not gated:
                continue
            # 15.1 gates: the served rows are the codec's rows.
            with service.lock:
                for c in range(SERVE_CLIENTS):
                    for r in range(SERVE_REQUESTS):
                        idx = np.load(io.BytesIO(enc[c][r][1]))
                        if not np.array_equal(idx, codec.encode_leaves(rows[c][r])):
                            raise AssertionError(f"/encode_leaves answer {c},{r} differs "
                                                 "from codec.encode_leaves of its rows")
                        leaves = np.load(io.BytesIO(dec[c][r][1]))
                        if not np.array_equal(leaves, codec.decode_indices(idx)):
                            raise AssertionError(f"/decode_indices answer {c},{r} differs "
                                                 "from codec.decode_indices")
            if stray[0] != 400 or "expected leaves" not in json.loads(stray[1])["error"]:
                raise AssertionError(f"malformed request: {stray[0]} {stray[1][:200]!r}")
            errors = service.stats()["counters"]["errors"] - errors0
            if errors != 1:
                raise AssertionError(f"{errors} requests failed; only the malformed one may")
            out["malformed"] = {"status": stray[0], "error": json.loads(stray[1])["error"]}
            for name, info, kernel in (("encode", enc_info, "score_argmin"),
                                       ("decode", dec_info, "dequantize")):
                expect_launches(f"served {name}", info["launches"],
                                **{kernel: info["device_batches"]})
                if info["device_batches"] < 1 or not (info["coalesced"] > 0
                                                      and info["steps"] < n_req):
                    raise AssertionError(f"served {name}: no coalescing: {info}")
        out["turns"] = turns

        # /encode of a .npy leaf array and /decode of the file it returns.
        raw = _npy_bytes(grid.leaves[:SERVE_FILE_LEAVES])
        status, vq = _http(addr, "POST", "/encode?name=density", raw)
        if status != 200:
            raise AssertionError(f"/encode: {status} {vq[:200]!r}")
        status, npz = _http(addr, "POST", "/decode", vq)
        if status != 200:
            raise AssertionError(f"/decode: {status} {npz[:200]!r}")
        path = workdir / "served.vqvdb"
        with service.lock:
            codec.compress(service.grid_of_npy(raw, "density"), path)
            if path.read_bytes() != vq:
                raise AssertionError("/encode bytes differ from codec.compress of its grid")
            (ref,), _ = codec.decompress(path)
        got = np.load(io.BytesIO(npz))
        if not (np.array_equal(got["density_leaves"], ref.leaves)
                and np.array_equal(got["density_origins"], ref.origins)):
            raise AssertionError("/decode differs from codec.decompress of the file")
        out["file"] = {"leaves": SERVE_FILE_LEAVES, "bytes": len(vq), "byte_identical": True,
                       "decode_equal": True}
        stats = json.loads(_http(addr, "GET", "/stats")[1])
        if "device/dispatch" not in stats["profile"]:
            raise AssertionError("/stats holds no device/dispatch profile")
        out["stats"] = {"counters": stats["counters"], "microbatch": stats["microbatch"],
                        "profile": stats["profile"]}
    finally:
        srv.shutdown()
        srv.server_close()
        server_thread.join(60)
        service.close()
    return out


def interop_phase(grid, workdir: Path, device: str = "cuda"):
    """Phase 15.2: `export-onnx` (validated on the card, --embed-header) of
    the flagship and of the reference arch; `export-torch` of the reference
    arch (the packed flagship has no reference module tree, in either
    package), its TorchScript decode of 64 index blocks on the card against
    decode_from_indices; the Houdini cooks with grids= on the card, their
    file api.encode's and their grids api.decode's."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch import api
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.weights import params_from_jax
    from vqvdb_tpu_torch.integrations import houdini
    from vqvdb_tpu_torch.models.blocks import no_tf32
    from vqvdb_tpu_torch.models.vqvae import decode_from_indices, encode_to_indices

    out = {}
    dev_flag = ["--device", device]
    for name in ("scalar", "scalar_reference"):
        d = workdir / f"onnx_{name}"
        reset_launches()
        rc, res = _cli(["export-onnx", REPO / "models" / f"{name}.vqmodel", d,
                        "--embed-header", d / "bin_onnx.h", *dev_flag])
        launches = read_launches()
        if rc != 0 or not res or not res.get("valid"):
            raise AssertionError(f"export-onnx {name}: exit {rc}, {res}")
        expect_launches(f"export-onnx {name} validation", launches,
                        nearest_indices=1, dequantize=2)
        out[f"export_onnx_{name}"] = {
            "valid": res["valid"], "encoder_index_agreement": res["encoder_index_agreement"],
            "decoder_max_abs_err": res["decoder_max_abs_err"], "launches": launches,
            "bytes": {k: Path(res[k]).stat().st_size
                      for k in ("encoder", "decoder", "embed_header")}}

    ref_model = REPO / "models" / "scalar_reference.vqmodel"
    d = workdir / "torch_ref"
    rc, res = _cli(["export-torch", ref_model, "--checkpoint", d / "ref.pth",
                    "--torchscript", d / "ref.pt", *dev_flag])
    if rc != 0:
        raise AssertionError(f"export-torch: exit {rc}")
    dev = torch.device(device)
    tree, cfg = load_model(ref_model)
    params = params_from_jax(tree, cfg, dev)
    module = torch.jit.load(str(d / "ref.pt"), map_location=dev)
    x = torch.from_numpy(np.ascontiguousarray(grid.leaves[:64])).to(dev)
    with torch.no_grad(), no_tf32(dev):
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            idx = encode_to_indices(params, x, cfg)
            scripted = module.decode(idx.long()).permute(0, 2, 3, 4, 1)
            mine = decode_from_indices(params, idx, cfg)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    err = float((scripted - mine).abs().max())
    if not err < 1e-5:
        raise AssertionError(f"TorchScript decode vs decode_from_indices: {err:.3e} >= 1e-5")
    sd = torch.load(d / "ref.pth", weights_only=True)["state_dict"]
    out["export_torch"] = {"state_dict_tensors": len(sd), "torchscript_decode_max_abs_err": err,
                           "blocks": 64}

    model = REPO / "models" / "scalar.vqmodel"
    sub = grid_subset(grid, SERVE_FILE_LEAVES)
    cooked, direct = workdir / "cook.vqvdb", workdir / "api.vqvdb"
    stats = houdini.cook_encoder(outputpath=str(cooked), model=str(model), grids=[sub],
                                 device=device)
    api.encode(sub, model, direct, device=device)
    if cooked.read_bytes() != direct.read_bytes():
        raise AssertionError("cook_encoder's file differs from api.encode's")
    (got,) = houdini.cook_decoder(inputfile=str(cooked), model=str(model), device=device)
    (want,), _ = api.decode(cooked, model, device=device)
    if not (np.array_equal(got.leaves, want.leaves) and np.array_equal(got.origins, want.origins)):
        raise AssertionError("cook_decoder's grid differs from api.decode's")
    out["houdini"] = {"leaves": stats["leaves"], "bytes": cooked.stat().st_size,
                      "byte_identical": True, "decode_equal": True}
    return out


# ---------------------------------------------------------------------------
# Phase 16: the mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3
MESH_RTOL, MESH_ATOL = 2e-4, 2e-5  # N ranks vs 1 rank, f32 (tests/test_parallel.py)


def _shard_steps(n, bs, size):
    """Shard steps of a mesh of `size` over n rows at batch bs; a shard wholly
    past a batch's rows is not run."""
    per = bs // size
    return sum(min(size, -(-min(bs, n - s) // per)) for s in range(0, n, bs))


def _deterministic():
    import torch

    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                       allow_tf32=cudnn.allow_tf32)


def _mesh_train(cfg, tcfg, leaves, dev, step_fn=None, rank=0, world=1):
    """MESH_TRAIN_STEPS train steps from seeded init on this rank's slice of
    consecutive global batches of `leaves`: (param leaves on the CPU, the
    metrics of each step)."""
    import torch

    from vqvdb_tpu_torch.train import train as T

    opt = T.make_optimizer(tcfg, 10)
    step_fn = step_fn or (lambda s, b: T.train_step(s, b, opt, cfg, tcfg))
    state = T.make_train_state(cfg, tcfg, 10, dev)
    bs, per = tcfg.batch_size, tcfg.batch_size // world
    metrics = []
    with _deterministic():
        for i in range(MESH_TRAIN_STEPS):
            rows = leaves[i * bs + rank * per: i * bs + (rank + 1) * per]
            state, m, _ = step_fn(state, torch.from_numpy(rows).to(dev))
            metrics.append({k: float(v) for k, v in m.items()})
    return [t.cpu() for t in T.tree_leaves(state.params)], metrics


def mesh_codec_phase(tree, cfg, codec, grid, refs, workdir: Path):
    """16.1: VQCodec(mesh=make_mesh()) over every visible card against the
    phase-3 codec: v3 and v6-int8 files byte-identical, decompress and the
    dense decode bit-identical, one launch per shard step, rates in turns."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
    from vqvdb_tpu_torch.parallel.mesh import make_mesh
    from vqvdb_tpu_torch.runtime.dense import decode_to_dense

    from vqvdb_tpu_torch.runtime.codec import VQCodec

    mesh = make_mesh()
    mcodec = VQCodec(tree, cfg, CodecConfig(), mesh=mesh)
    mcodec.compress(grid_subset(grid, 5000), workdir / "mesh_warm.vqvdb")
    mcodec.decompress(workdir / "mesh_warm.vqvdb")
    mesh.synchronize()
    n, bs = grid.num_leaves, mcodec.ccfg.batch_size
    steps = _shard_steps(n, bs, mesh.size)
    out = {"cards": mesh.size, "devices": [str(d) for d in mesh.devices],
           "rows_per_shard": bs // mesh.size, "shard_steps": steps}
    for tier, opts in (("v3", {}), ("v6_int8", dict(residual="int8"))):
        path = workdir / f"mesh_{tier}.vqvdb"
        reset_launches()
        mcodec.compress(grid, path, **opts)
        enc = read_launches()
        expect_launches(f"mesh {tier} encode", enc, score_argmin=steps,
                        **({"dequantize": steps} if opts else {}))
        if path.read_bytes() != refs[tier].read_bytes():
            raise AssertionError(f"mesh {tier} file differs from the single-device file")
        out[f"{tier}_byte_identical"] = True
        out[f"{tier}_encode_launches"] = enc
    reset_launches()
    (got,), _ = mcodec.decompress(refs["v3"])
    out["decode_launches"] = read_launches()
    expect_launches("mesh decode", out["decode_launches"], dequantize=steps)
    (want,), _ = codec.decompress(refs["v3"])
    if not np.array_equal(got.leaves, want.leaves):
        raise AssertionError("mesh decompress differs from the single-device decompress")
    out["decompress_bit_identical"] = True
    with VqvdbReader(refs["v3"]) as r:
        _, idx, origins = r.read_grid()
    a, _ = decode_to_dense(codec, idx, origins)
    b, _ = decode_to_dense(mcodec, idx, origins)
    if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
        raise AssertionError("mesh decode_to_dense differs from the single-device one")
    out["dense_decode_bit_equal"] = {"shape": list(a.shape)}
    del a, b
    rates = {"plain": [], "mesh": []}
    for label, c in (("plain", codec), ("mesh", mcodec), ("mesh", mcodec), ("plain", codec)):
        cs = c.compress(grid, workdir / "rate.vqvdb")
        _, ds = c.decompress(workdir / "rate.vqvdb")
        rates[label].append({"compress": cs["leaves_per_sec"],
                             "decompress": ds["leaves_per_sec"]})
    out["rates_in_turns"] = rates
    # The host's share of a mesh batch: copy_into of one decoded batch
    # (4096 leaves, 8 MiB) by each thread count.
    from vqvdb_tpu_torch.runtime.native_io import copy_into

    src = np.ones((bs, 8, 8, 8, 1), np.float32)
    dst = np.empty_like(src)
    out["copy_into_8mib_ms"] = {}
    for threads in (1, 2, 4, 0):
        copy_into(dst, src, threads)
        t0 = time.perf_counter()
        for _ in range(20):
            copy_into(dst, src, threads)
        out["copy_into_8mib_ms"][threads or "all"] = (time.perf_counter() - t0) / 20 * 1e3
    return out


def group_of_one_phase(tree, cfg, grid, refs, workdir: Path, seed: int):
    """16.2: an in-process NCCL group of one rank on a file store: three
    flagship-config train steps under group= bit-equal to three without it,
    and the multi-process codec's v3 file equal to the single-device file."""
    import torch
    import torch.distributed as dist

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.parallel.distributed import init_multi_host
    from vqvdb_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.train import train as T

    info = init_multi_host(f"file://{workdir}/store_one", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        dev = mesh.devices[0]
        tcfg = T.TrainConfig(seed=seed)  # the flagship's: batch 2048, bf16
        plain, m_plain = _mesh_train(cfg, tcfg, grid.leaves, dev)
        step = make_sharded_train_step(mesh, T.make_optimizer(tcfg, 10), cfg, tcfg)
        reset_launches()
        grouped, m_grouped = _mesh_train(cfg, tcfg, grid.leaves, dev, step)
        launches = read_launches()
        expect_launches("group-of-one train steps", launches,
                        nearest_indices=MESH_TRAIN_STEPS, dequantize=MESH_TRAIN_STEPS)
        if not (all(torch.equal(a, b) for a, b in zip(plain, grouped)) and m_plain == m_grouped):
            raise AssertionError("train steps under an NCCL group of one differ from "
                                 "steps without a group")
        mc = VQCodec(tree, cfg, CodecConfig(), mesh=mesh)
        path = workdir / "group_v3.vqvdb"
        reset_launches()
        mc.compress(grid, path)
        enc = read_launches()
        expect_launches("group-of-one encode", enc,
                        score_argmin=-(-grid.num_leaves // mc.ccfg.batch_size))
        if path.read_bytes() != refs["v3"].read_bytes():
            raise AssertionError("the multi-process codec's file differs from the "
                                 "single-device file")
        return {"backend": dist.get_backend(), "info": info, "train_steps": MESH_TRAIN_STEPS,
                "batch_size": tcfg.batch_size, "compute_dtype": tcfg.compute_dtype,
                "train_bit_equal": True, "train_launches": launches,
                "codec_v3_byte_identical": True, "codec_encode_launches": enc,
                "loss": [m["loss"] for m in m_grouped]}
    finally:
        dist.destroy_process_group()


def _mesh_rank(rank, world, store, workdir, seed):
    """One NCCL rank of phase 16.3 (a torch.multiprocessing child): the
    multi-process codec's v3 and v6-int8 files and MESH_TRAIN_STEPS f32 train
    steps on its slice, written to workdir."""
    import os

    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.parallel.distributed import init_multi_host
    from vqvdb_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.train import train as T
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    workdir = Path(workdir)
    init_multi_host(store, world, rank, backend="nccl")
    try:
        mesh = make_mesh()
        tree, cfg = load_model(REPO / "models" / "scalar.vqmodel")
        grid = LeafGrid("density", np.load(workdir / "origins.npy"),
                        np.load(workdir / "leaves.npy"))
        codec = VQCodec(tree, cfg, CodecConfig(), mesh=mesh)
        for tier, opts in (("v3", {}), ("v6_int8", dict(residual="int8"))):
            codec.compress(grid, workdir / f"rank{rank}_{tier}.vqvdb", **opts)
        tcfg = T.TrainConfig(seed=seed, compute_dtype="float32")
        step = make_sharded_train_step(mesh, T.make_optimizer(tcfg, 10), cfg, tcfg)
        params, metrics = _mesh_train(cfg, tcfg, grid.leaves, mesh.devices[0], step,
                                      rank, world)
        np.savez(workdir / f"rank{rank}_params.npz", *[p.numpy() for p in params],
                 loss=np.array([m["loss"] for m in metrics]))
    finally:
        dist.destroy_process_group()


def ranks_phase(cfg, grid, refs, workdir: Path, seed: int, ranks: int):
    """16.3: `ranks` NCCL ranks, one per card (torch.multiprocessing, a file
    store): every rank's v3 and v6-int8 files byte-identical to the
    single-device files; MESH_TRAIN_STEPS f32 train steps (TF32 off) of the
    ranks bit-identical to each other and within the CPU test's tolerance
    of one process on the global batches."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from vqvdb_tpu_torch.train import train as T

    if torch.cuda.device_count() < ranks:
        raise AssertionError(f"--ranks {ranks} wants {ranks} cards, "
                             f"{torch.cuda.device_count()} visible")
    np.save(workdir / "leaves.npy", grid.leaves)
    np.save(workdir / "origins.npy", grid.origins)
    tcfg = T.TrainConfig(seed=seed, compute_dtype="float32")
    with _no_tf32_matmul():
        one, m_one = _mesh_train(cfg, tcfg, grid.leaves, torch.device("cuda", 0))
    t0 = time.perf_counter()
    mp.spawn(_mesh_rank, args=(ranks, f"file://{workdir}/store_ranks", str(workdir), seed),
             nprocs=ranks)
    wall = time.perf_counter() - t0
    for r in range(ranks):
        for tier in ("v3", "v6_int8"):
            if (workdir / f"rank{r}_{tier}.vqvdb").read_bytes() != refs[tier].read_bytes():
                raise AssertionError(f"rank {r}: its {tier} file differs from the "
                                     "single-device file")
    got = [np.load(workdir / f"rank{r}_params.npz") for r in range(ranks)]
    keys = [f"arr_{i}" for i in range(len(one))]
    for r in range(1, ranks):
        if not all(np.array_equal(got[r][k], got[0][k]) for k in keys + ["loss"]):
            raise AssertionError(f"rank {r} ended in another state than rank 0")
    worst = 0.0
    for k, want in zip(keys, one):
        want = want.numpy()
        err = np.abs(got[0][k] - want)
        if not (err <= MESH_ATOL + MESH_RTOL * np.abs(want)).all():
            raise AssertionError(f"{ranks} ranks vs one: params differ by {err.max():.3g}")
        worst = max(worst, float(err.max()))
    loss_err = float(np.max(np.abs(got[0]["loss"] - np.array([m["loss"] for m in m_one]))
                            / np.abs(got[0]["loss"])))
    if not loss_err <= 1e-5:
        raise AssertionError(f"{ranks} ranks vs one: loss differs by {loss_err:.3g} relative")
    return {"ranks": ranks, "files_byte_identical": True, "ranks_bit_identical": True,
            "param_max_abs_err_vs_one": worst, "loss_max_rel_err_vs_one": loss_err,
            "wall_s": wall}


def _no_tf32_matmul():
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    return ctx()


def mesh_phase(args, tree, cfg, codec, grid, refs, workdir: Path):
    """Phase 16: 16.1, 16.2 and, with --ranks N > 1, 16.3; each logged as
    `[mesh] <part> {...}`."""
    res = {}
    t0 = time.perf_counter()
    res["codec"] = mesh_codec_phase(tree, cfg, codec, grid, refs, workdir)
    log(f"[mesh] codec {json.dumps(res['codec'])}")
    res["group_of_one"] = group_of_one_phase(tree, cfg, grid, refs, workdir, args.seed)
    log(f"[mesh] group_of_one {json.dumps(res['group_of_one'])}")
    if args.ranks > 1:
        res["ranks"] = ranks_phase(cfg, grid, refs, workdir, args.seed, args.ranks)
        log(f"[mesh] ranks {json.dumps(res['ranks'])}")
    else:
        log("[mesh] ranks: 1 (--ranks N spawns N NCCL ranks over N cards)")
    log(f"[phase16] {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 17: packed_stem and the folded final conv
# ---------------------------------------------------------------------------

FOLDED_TAIL_ATOL = 1e-5  # folded final conv vs the fused tail GEMM, f32, TF32 off


def stem_phase(args, flag_tree, flag_cfg, grid, flag_file: Path, workdir: Path):
    """Phase 17: (1) a packed_stem model at the flagship's widths trained
    from seeded init on the card (one resident epoch, batch 2048, bf16),
    save_model -> VQCodec -> v3 round trip above its initial params' PSNR;
    (2) its card-vs-CPU parity (phase 9's gates); (3) the flagship decoded
    through the folded final conv (fuse_decoder_tail=False) in f32, TF32
    off, against the fused tail, on the first 16,384 blocks of the phase-3
    file `flag_file`."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.artifact import load_model, save_model
    from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.train import train as T
    from vqvdb_tpu_torch.train.fast import train_on_device

    t0 = time.perf_counter()
    out = {}
    cfg = ModelConfig(embedding_dim=flag_cfg.embedding_dim,
                      num_embeddings=flag_cfg.num_embeddings, encoder_arch="packed_stem")
    tcfg = T.TrainConfig(epochs=1, seed=args.seed)
    steps, vals = _split_counts(grid.num_leaves, tcfg)
    reset_launches()
    t1 = time.perf_counter()
    state, trace = train_on_device(grid.leaves, cfg, tcfg, device="cuda", log_fn=_quiet)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches = read_launches()
    expect_launches("packed_stem training", launches, nearest_indices=steps + vals,
                    dequantize=steps + vals)
    if not np.isfinite(trace).all():
        raise AssertionError(f"packed_stem training: metrics not finite: {trace}")
    psnrs = {}
    for label, params in (("init", T.make_train_state(cfg, tcfg, 1, "cpu").params),
                          ("trained", state.params)):
        path = workdir / f"stem_{label}.vqmodel"
        save_model(path, params, cfg)
        tree, cfg2 = load_model(path)
        res = round_trip(f"packed_stem_{label}", VQCodec(tree, cfg2, CodecConfig(),
                                                         device="cuda"),
                         grid, workdir, min_psnr=0.0)
        n = res["batches"]
        expect_launches(f"packed_stem {label} encode", res["encode_launches"], score_argmin=n)
        expect_launches(f"packed_stem {label} decode", res["decode_launches"], dequantize=n)
        psnrs[label] = res["psnr_db"]
        out[f"round_trip_{label}"] = res
    if not psnrs["trained"] > psnrs["init"]:
        raise AssertionError(f"packed_stem: trained PSNR {psnrs['trained']:.2f} dB does not "
                             f"beat the initial params' {psnrs['init']:.2f} dB")
    out["train"] = {"steps": steps, "val_batches": vals, "batch_size": tcfg.batch_size,
                    "compute_dtype": tcfg.compute_dtype, "seconds": train_s,
                    "steps_per_s": steps / train_s, "trace": trace.tolist(),
                    "launches": launches}
    log(f"[stem] train {json.dumps(out['train'])}")
    log(f"[stem] round_trip {json.dumps({k: out[k] for k in out if k.startswith('round')})}")
    tree, _ = load_model(workdir / "stem_trained.vqmodel")
    with _no_tf32_matmul():
        out["parity"] = parity_phase("packed_stem", tree, cfg, grid)
    log(f"[stem] parity {json.dumps(out['parity'])}")
    idx = _file_indices(flag_file)[:16384]
    with _no_tf32_matmul():
        fused = VQCodec(flag_tree, flag_cfg, CodecConfig(compute_dtype="float32"),
                        device="cuda")
        folded = VQCodec(flag_tree, flag_cfg, CodecConfig(compute_dtype="float32",
                                                          fuse_decoder_tail=False),
                         device="cuda")
        reset_launches()
        a = folded.decode_indices(idx)
        dec = read_launches()
        b = fused.decode_indices(idx)
    expect_launches("folded final conv decode", dec,
                    dequantize=-(-idx.shape[0] // folded.ccfg.batch_size))
    err = float(np.abs(a - b).max())
    if not (np.isfinite(a).all() and err <= FOLDED_TAIL_ATOL):
        raise AssertionError(f"folded final conv vs fused tail: {err:.3g} > {FOLDED_TAIL_ATOL}")
    out["folded_final_conv"] = {"leaves": int(idx.shape[0]), "max_abs_err_vs_fused_tail": err,
                                "atol": FOLDED_TAIL_ATOL, "launches": dec}
    log(f"[stem] folded_final_conv {json.dumps(out['folded_final_conv'])}")
    log(f"[phase17] {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: output independent of the layout
# ---------------------------------------------------------------------------

LAYOUT_ENTRIES = (2, 4, 8, 16)  # shards of 2,048 down to 256 rows at batch 4096
LAYOUT_BATCHES = (4096, 2048, 1024)  # the batch sizes of the several-card part


def _one_card_mesh(entries: int):
    """A mesh of `entries` entries on cuda:0, each on its own stream: every
    shard step runs at the shape that `entries` cards would run it at."""
    import torch

    from vqvdb_tpu_torch.parallel.mesh import Mesh

    return Mesh((torch.device("cuda", 0),) * entries, entries)


def _layout_launches(label, n, batch, size):
    """The launches each model's encode and decode make on a mesh of `size`
    over n leaves: one per kernel and stage a shard step."""
    steps = _shard_steps(n, batch, size)
    return {"scalar": (dict(score_argmin=steps), dict(dequantize=steps)),
            "scalar_v6_int8": (dict(score_argmin=steps, dequantize=steps), None),
            "scalar_reference": (dict(fused_rb=steps, score_argmin=steps),
                                 dict(dequantize=steps)),
            "scalar_rvq2": (dict(nearest_indices=2 * steps, dequantize=2 * steps),
                            dict(dequantize=2 * steps))}[label]


def _layout_case(label, tree, cfg, ref, mesh, workdir: Path, batch: int = 4096):
    """One model on `mesh`: each file of `ref["files"]` (tier -> (path,
    compress options)) written byte for byte, decompress bit-equal to
    `ref["leaves"]`, and the dense decode to `ref["dense"]` where given;
    launches counted per shard step. Returns the launch counts."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.runtime.dense import decode_to_dense

    codec = VQCodec(tree, cfg, CodecConfig(batch_size=batch), mesh=mesh)
    grid = ref["grid"]
    out = {}
    for tier, (path, opts) in ref["files"].items():
        name = label if tier == "v3" else f"{label}_{tier}"
        reset_launches()
        codec.compress(grid, workdir / "layout.vqvdb", **opts)
        out[f"{tier}_encode"] = read_launches()
        expect_launches(f"layout {name} encode on {mesh.size}", out[f"{tier}_encode"],
                        **_layout_launches(name, grid.num_leaves, batch, mesh.size)[0])
        if (workdir / "layout.vqvdb").read_bytes() != path.read_bytes():
            raise AssertionError(f"layout: {name} on a mesh of {mesh.size} (batch {batch}) "
                                 "writes another file than one card")
    reset_launches()
    (got,), _ = codec.decompress(ref["files"]["v3"][0])
    out["decode"] = read_launches()
    expect_launches(f"layout {label} decode on {mesh.size}", out["decode"],
                    **_layout_launches(label, grid.num_leaves, batch, mesh.size)[1])
    if not np.array_equal(got.leaves, ref["leaves"]):
        raise AssertionError(f"layout: {label} decompress on a mesh of {mesh.size} differs")
    if "dense" in ref:
        with VqvdbReader(ref["files"]["v3"][0]) as r:
            _, idx, origins = r.read_grid()
        dense, _ = decode_to_dense(codec, idx, origins)
        if dense.shape != ref["dense"].shape or not torch.equal(dense, ref["dense"]):
            raise AssertionError(f"layout: {label} dense decode on a mesh of {mesh.size} "
                                 "differs")
        del dense
    return out


def _layout_ref(codec, grid, files, dense: bool = False):
    """What a mesh is held to: one card's files (tier -> (path, options)),
    its decompress of the v3 file and, with `dense`, its dense decode."""
    from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
    from vqvdb_tpu_torch.runtime.dense import decode_to_dense

    (want,), _ = codec.decompress(files["v3"][0])
    ref = {"grid": grid, "files": files, "leaves": want.leaves}
    if dense:
        with VqvdbReader(files["v3"][0]) as r:
            _, idx, origins = r.read_grid()
        ref["dense"], _ = decode_to_dense(codec, idx, origins)
    return ref


def layout_models(tree, cfg, codec, grid, refs, side_leaves: int, others=None):
    """Phase 18's models: label -> (tree, cfg, one card's codec, leaves, one
    card's files). The flagship's are phase 3's v3 and phase 10's v6-int8
    files; the reference arch's and scalar_rvq2's phase 5's and 6's v3 files
    (`others`: label -> (tree, cfg, codec)), or, without them (--mesh-only),
    written here by a default codec on one card."""
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    data = {"scalar_reference": grid, "scalar_rvq2": grid_subset(grid, side_leaves)}
    models = {"scalar": (tree, cfg, codec, grid,
                         {"v3": (refs["v3"], {}),
                          "v6_int8": (refs["v6_int8"], dict(residual="int8"))})}
    for label, leaves in data.items():
        if others is None:
            t, c = load_model(REPO / "models" / f"{label}.vqmodel")
            one = VQCodec(t, c, CodecConfig(), device="cuda")
            one.compress(leaves, refs[label])
        else:
            t, c, one = others[label]
        models[label] = (t, c, one, leaves, {"v3": (refs[label], {})})
    return models


def layout_phase(models, workdir: Path):
    """Phase 18: `tools/batch_invariance.py` (every stage of the three
    models' steps, the kernels included, bit-equal at 2,048-256 rows in bf16
    and f32, TF32 off), then each of `models` (label -> (tree, cfg, one
    card's codec, grid, files)) on one-card meshes of LAYOUT_ENTRIES entries
    at batch 4096 against one card, and with several cards the flagship on
    a mesh of every card at each of LAYOUT_BATCHES against one card at the
    same batch size. Logs `[layout] <part> {...}`."""
    import torch

    from vqvdb_tpu_torch.core.config import CodecConfig
    from vqvdb_tpu_torch.parallel.mesh import make_mesh
    from vqvdb_tpu_torch.runtime.codec import VQCodec
    from vqvdb_tpu_torch.tools import batch_invariance

    t0 = time.perf_counter()
    res = {}
    with _no_tf32_matmul():
        inv = batch_invariance.stages("cuda")
    moved = {f"{m}/{d}/{k}": v for m, by_dtype in inv["stages"].items()
             for d, st in by_dtype.items() for k, v in st.items() if not all(v.values())}
    log(f"[layout] batch_invariance {json.dumps(inv)}")
    if moved:
        raise AssertionError(f"layout: stages whose rows move with the batch: {moved}")
    res["stages_bit_equal"] = sorted({k for by_dtype in inv["stages"].values()
                                      for st in by_dtype.values() for k in st})
    refs = {label: _layout_ref(codec, grid, files, dense=label == "scalar")
            for label, (_, _, codec, grid, files) in models.items()}
    for entries in LAYOUT_ENTRIES:
        mesh = _one_card_mesh(entries)
        t1 = time.perf_counter()
        part = {label: _layout_case(label, tree, cfg, refs[label], mesh, workdir)
                for label, (tree, cfg, _, _, _) in models.items()}
        part["seconds"] = time.perf_counter() - t1
        res[f"entries_{entries}"] = part
        log(f"[layout] one card, {entries} entries of {4096 // entries} rows: "
            f"{json.dumps(part)}")
    cards = torch.cuda.device_count()
    if cards > 1:
        tree, cfg, _, grid, _ = models["scalar"]
        mesh = make_mesh()
        for batch in LAYOUT_BATCHES:
            single = VQCodec(tree, cfg, CodecConfig(batch_size=batch), device="cuda")
            files = {"v3": (workdir / f"one_{batch}_v3.vqvdb", {}),
                     "v6_int8": (workdir / f"one_{batch}_v6.vqvdb", dict(residual="int8"))}
            for path, opts in files.values():
                single.compress(grid, path, **opts)
            part = _layout_case("scalar", tree, cfg,
                                _layout_ref(single, grid, files, dense=True), mesh,
                                workdir, batch)
            res[f"cards_{cards}_batch_{batch}"] = part
            log(f"[layout] {cards} cards, batch {batch} ({batch // cards} rows a shard): "
                f"files, decompress and dense decode as one card's {json.dumps(part)}")
    log(f"[phase18] {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 19: the CLI's bench
# ---------------------------------------------------------------------------

BENCH_EXTRA_KEYS = ("vec3_decode_leaves_per_sec", "vec3_encode_leaves_per_sec",
                    "rvq2_decode_leaves_per_sec", "rvq2_encode_leaves_per_sec",
                    "dense_decode_leaves_per_sec", "dense_encode_leaves_per_sec",
                    "dense_decode_device_leaves_per_sec",
                    "dense_encode_device_leaves_per_sec")
H100_SXM = "NVIDIA H100 80GB HBM3"


def _bench_capture_launches(row: str, dense_steps: int):
    """The launches one captured step of a bench row must record."""
    if row.startswith("baseline"):
        row = "decode"
    return {"decode": {"dequantize": 1}, "encode": {"score_argmin": 1},
            "vec3_decode": {"dequantize": 1}, "vec3_encode": {"score_argmin": 1},
            "rvq2_decode": {"dequantize": 2},
            "rvq2_encode": {"nearest_indices": 2, "dequantize": 2},
            "dense_decode_device": {"dequantize": dense_steps},
            "dense_encode_device": {"score_argmin": dense_steps,
                                    "fused_rb": dense_steps}}[row]


def bench_padding(turns=(64, 1024, 1024, 64)):
    """The baseline's decode step (f32, the tail unfolded) at batch 64, which
    `models/blocks.py` pads to one 1,024-row block, against the same step at
    1,024 rows, in turns: {batch: [leaves/s]}, ms a step, and the leaves/s
    that the padding costs at batch 64 (factor = rate at 1,024 / at 64)."""
    import numpy as np
    import torch

    from vqvdb_tpu_torch import bench
    from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
    from vqvdb_tpu_torch.runtime.codec import VQCodec

    cfg = ModelConfig()
    params = bench.untrained_params(cfg)
    idx = np.random.default_rng(0).integers(0, 256, (max(turns), 4, 4, 4)).astype(np.uint8)
    rates, ms = {b: [] for b in turns}, {b: [] for b in turns}
    for b in turns:
        codec = VQCodec(params, cfg, CodecConfig(batch_size=b, compute_dtype="float32",
                                                 fuse_decoder_tail=False,
                                                 fuse_final_conv=False), device="cuda")
        rec = {}
        with bench.f32_math():  # as the bench's baseline runs
            rates[b].append(bench.fenced_rate(
                codec._decode_step, torch.from_numpy(idx[:b]).cuda(),
                bench.CARD.baseline_steps, bench.perturb_indices(256), bench.consume_sum,
                record=rec))
        ms[b].append(rec["ms_per_step"])
        if not rec["bit_equal"]:
            raise AssertionError(f"padding batch {b}: replay differs from the eager step")
    lo, hi = min(turns), max(turns)
    return {"leaves_per_s": rates, "ms_per_step": ms,
            "factor": float(np.median(rates[hi]) / np.median(rates[lo]))}


def bench_phase(smi: str, kind: str):
    """Phase 19: `vqvdb_tpu_torch.bench.run(data_parallel=True)` (what
    `python -m vqvdb_tpu_torch.bench --data-parallel` prints; `cli bench`
    prints it without the data-parallel keys) at its card sizes, the launch
    counters reset before and read after. Fails unless every rate and time
    is finite and > 0, `mesh_devices` is the visible cards, every captured
    row's replay is bit-equal to its eager step, each capture recorded its
    row's kernel launches, and on an H100 SXM the decode and encode MFU lie
    in (0, 1]. Then `bench_padding`."""
    import math

    from vqvdb_tpu_torch import bench

    import torch

    checks = []
    reset_launches()
    line = bench.run("cuda", checks=checks, data_parallel=True)
    launches = read_launches()
    log(f"[bench] card: {smi}")
    log(f"[bench] {json.dumps(line)}")
    log(f"[bench] rows {json.dumps(checks)}")
    missing = [k for k in BENCH_EXTRA_KEYS + bench.DP_KEYS if k not in line]
    if missing:
        raise AssertionError(f"bench: rows missing {missing}")
    if line["mesh_devices"] != torch.cuda.device_count():
        raise AssertionError(f"bench: mesh_devices {line['mesh_devices']}, "
                             f"{torch.cuda.device_count()} cards visible")
    rates = {k: v for k, v in line.items()
             if k == "value" or k.endswith(("_per_sec", "_per_chip", "_per_batch"))}
    rates.update({f"baseline_run_{i}": r for i, r in enumerate(line["baseline_runs"])})
    for key, r in rates.items():
        if not (isinstance(r, (int, float)) and math.isfinite(r) and r > 0):
            raise AssertionError(f"bench: {key} = {r}")
    dense_steps = -(-math.prod(bench.CARD.dense_blocks) // bench.CARD.dense_batch)
    for rec in checks:
        if not rec["bit_equal"]:
            raise AssertionError(f"bench {rec['row']}: the replayed graph's output differs "
                                 f"from the eager step's (max abs {rec['max_abs_diff']})")
        expect_launches(f"bench {rec['row']} capture", rec["launches"],
                        **_bench_capture_launches(rec["row"], dense_steps))
    if kind == H100_SXM:
        for key in ("decode_mfu", "encode_mfu"):
            if line[key] is None or not 0.0 < line[key] <= 1.0:
                raise AssertionError(f"bench: {key} = {line[key]} on an {kind}")
    padding = bench_padding()
    log(f"[bench] padding {json.dumps(padding)}")
    return line, launches


# ---------------------------------------------------------------------------
# Phase 20: the data-parallel bench
# ---------------------------------------------------------------------------

DP_LEAVES = 100_000  # bench.py --data-parallel's file on the card
DP_BATCH = 2048
DP_ENTRIES = (2, 4, 8)  # one-card meshes: the shard shapes of 2-, 4- and 8-card hosts


def dp_phase():
    """Phase 20: `bench_dp.bench_mesh_size` (bf16, batch 2,048, 100,000
    leaves) with no mesh, on a mesh of every visible card and on one-card
    meshes of DP_ENTRIES entries, the launch counters reset before and read
    after. Fails unless every rate and time is finite and > 0 (the per-shard
    gather bit-equal to the full gather: `host_stage_times` raises
    otherwise), each row's file and decoded leaves are the no-mesh row's,
    and the compress and the timed decode pass launch score-argmin and the
    fused block (dequantize) once per shard step. Returns (rows, launches)."""
    import math

    import numpy as np
    import torch

    from vqvdb_tpu_torch import bench_dp
    from vqvdb_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    cases = [("no mesh", 0, None), (f"every card ({cards})", cards, make_mesh())]
    cases += [(f"one card, {e} entries", e, _one_card_mesh(e)) for e in DP_ENTRIES]
    ref = None
    rows = {}
    reset_launches()
    for label, n, mesh in cases:
        rec = {}
        t1 = time.perf_counter()
        row = bench_dp.bench_mesh_size(n, DP_BATCH, DP_LEAVES, "bfloat16", "cuda", mesh=mesh,
                                       record=rec)
        steps = _shard_steps(DP_LEAVES, DP_BATCH, max(n, 1))
        log(f"[dp] {label}: {json.dumps(row)} shard steps {steps}, compress launches "
            f"{json.dumps(rec['compress_launches'])}, decode launches "
            f"{json.dumps(rec['decode_launches'])}, {time.perf_counter() - t1:.1f} s")
        for key, v in row.items():
            if key.endswith(("_per_sec", "_per_batch")) and not (math.isfinite(v) and v > 0):
                raise AssertionError(f"dp {label}: {key} = {v}")
        expect_launches(f"dp {label} compress", rec["compress_launches"],
                        score_argmin=steps, fused_rb=steps)
        expect_launches(f"dp {label} decode", rec["decode_launches"], dequantize=steps)
        if ref is None:
            if not np.isfinite(rec["leaves"]).all():
                raise AssertionError("dp: the no-mesh decode is not finite")
            ref = rec
        elif rec["file"] != ref["file"]:
            raise AssertionError(f"dp {label}: another file than with no mesh")
        elif rec["leaves"].tobytes() != ref["leaves"].tobytes():
            raise AssertionError(f"dp {label}: other decoded leaves than with no mesh")
        rows[label] = row
    launches = read_launches()
    log(f"[dp] card: {smi_line()}")
    log(f"[phase20] {time.perf_counter() - t0:.1f} s")
    return rows, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--leaves", type=int, default=70000)
    ap.add_argument("--side-leaves", type=int, default=17161)
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR")
    ap.add_argument("--ranks", type=int, default=1,
                    help="phase 16.3: spawn this many NCCL ranks, one per card")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run phases 1-3, 16 and 18 only (the multi-card measurement)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.ops import build
    from vqvdb_tpu_torch.runtime import native_io

    t_start = time.perf_counter()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[build] {len(reports)} kernel libraries built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    native_io.backend()  # the LZ4 library of the v5/v6 frames, built here, not in a tier
    log(f"[build] native LZ4 library ready in {time.perf_counter() - t0:.1f} s")
    if args.profile is not None:
        args.profile.mkdir(parents=True, exist_ok=True)
        (args.profile / "ptxas.txt").write_text(
            "\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] tensor-core instructions in the built code: {json.dumps(mma_counts(args.profile))}")

    tree, cfg = load_model(REPO / "models" / "scalar.vqmodel")
    t0 = time.perf_counter()
    grid = smooth_field(args.seed, args.leaves)
    log(f"[data] {grid.num_leaves} leaves ({grid.leaves.nbytes / 2**20:.0f} MiB f32) "
        f"from seed {args.seed} in {time.perf_counter() - t0:.1f} s")

    # The phase-3 codec's v3 and v6-int8 files, which phase 16 holds the mesh to.
    keep_dir = tempfile.TemporaryDirectory()
    keep = Path(keep_dir.name)
    refs = {"v3": keep / "main_v3.vqvdb", "v6_int8": keep / "main_v6_int8.vqvdb",
            "scalar_reference": keep / "reference_v3.vqvdb",
            "scalar_rvq2": keep / "rvq2_v3.vqvdb"}
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        codec, main_res = main_path(tree, cfg, grid, workdir)
        shutil.copy(workdir / "main.vqvdb", refs["v3"])
        log(f"[main] {json.dumps(main_res)}")
        log(f"[phase3] {time.perf_counter() - t0:.1f} s")
        if args.mesh_only:
            codec.compress(grid, refs["v6_int8"], residual="int8")
            mesh_phase(args, tree, cfg, codec, grid, refs, workdir)
            layout_phase(layout_models(tree, cfg, codec, grid, refs, args.side_leaves),
                         workdir)
            keep_dir.cleanup()
            log(f"[done] {time.perf_counter() - t_start:.1f} s")
            print(json.dumps({"kernels": []}))
            print(smi)
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                     "count": torch.cuda.device_count()}}))
            return 0
        kernels = log_kernel_rows(kernel_phase(codec, grid))
        if args.profile is not None:
            log(f"[profile] {json.dumps(profile_batches(codec, grid, args.profile))}")

        ref_tree, ref_cfg, ref_codec, ref_res = reference_path(grid, workdir)
        shutil.copy(workdir / "reference.vqvdb", refs["scalar_reference"])
        log(f"[reference] {json.dumps(ref_res)}")
        side, vgrid, side_res = side_paths(args.seed, args.side_leaves, grid, workdir)
        shutil.copy(workdir / "scalar_rvq2.vqvdb", refs["scalar_rvq2"])
        for label, res in side_res.items():
            log(f"[{label}] {json.dumps(res)}")
        kernels += log_kernel_rows(
            side_kernel_phase(ref_codec, grid, side["vec3"][2], vgrid))
        if args.profile is not None:
            # (not `codec`: the flagship's codec runs the later phases)
            for label, side_codec, data in (("reference", ref_codec, grid),
                                            ("scalar_rvq2", side["scalar_rvq2"][2], grid),
                                            ("vec3", side["vec3"][2], vgrid)):
                prof = profile_batches(side_codec, data, args.profile, f"{label}_")
                log(f"[profile {label}] {json.dumps(prof)}")

        torch.backends.cudnn.allow_tf32 = False
        unf = unfused_path(tree, cfg, grid_subset(grid, 16384 + 777), workdir)
        log(f"[unfused] {json.dumps(unf)}")
    par = {}
    for label, model, data in (("scalar", (tree, cfg), grid),
                               ("scalar_reference", (ref_tree, ref_cfg), grid),
                               ("scalar_rvq2", side["scalar_rvq2"][:2], grid),
                               ("scalar_packed_lite", None, grid),
                               ("vec3", side["vec3"][:2], vgrid),
                               ("vec3_rvq2", None, vgrid)):
        model = model or load_model(REPO / "models" / f"{label}.vqmodel")
        par[label] = parity_phase(label, *model, data)
        log(f"[parity] {json.dumps(par[label])}")
    for label in ("scalar_rvq2", "vec3_rvq2"):
        expect_launches(f"{label} f32 encode", par[label]["launches"],
                        nearest_indices=2, dequantize=2)

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        tier_phase(codec, grid, workdir)
        shutil.copy(workdir / "v6_int8.vqvdb", refs["v6_int8"])
        rvq = side["scalar_rvq2"][2]
        rvq_res = tier_round_trip("scalar_rvq2 v6_f16", rvq, grid_subset(grid, args.side_leaves),
                                  workdir / "rvq2.vqvdb", residual="f16")
        log(f"[tiers] scalar_rvq2 v6_f16: {json.dumps(rvq_res)}")
        big_res, big_row = large_codebook_phase(tree, cfg, grid, args.seed, workdir)
        log(f"[k4096] {json.dumps(big_res)}")
        kernels += log_kernel_rows([big_row])
    with tempfile.TemporaryDirectory() as tmp:
        user = user_path(codec, grid, Path(tmp))
        log(f"[user] {json.dumps(user)}")
    with tempfile.TemporaryDirectory() as tmp:
        deep_res, deep_rows = deep_rows_phase(args.seed, grid, Path(tmp))
        log(f"[deep] {json.dumps(deep_res)}")
        kernels += log_kernel_rows(deep_rows)
    with tempfile.TemporaryDirectory() as tmp:
        train_res, train_rows = train_phase(args, cfg, grid, Path(tmp))
        kernels += log_kernel_rows(train_rows)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        log(f"[serve] {json.dumps(serving_phase(args.seed, grid, Path(tmp)))}")
        log(f"[interop] {json.dumps(interop_phase(grid, Path(tmp)))}")
        log(f"[phase15] {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        mesh_res = mesh_phase(args, tree, cfg, codec, grid, refs, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        stem_res = stem_phase(args, tree, cfg, grid, refs["v3"], Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        others = {"scalar_reference": (ref_tree, ref_cfg, ref_codec),
                  "scalar_rvq2": side["scalar_rvq2"]}
        layout_res = layout_phase(layout_models(tree, cfg, codec, grid, refs,
                                                args.side_leaves, others), Path(tmp))
    keep_dir.cleanup()
    t0 = time.perf_counter()
    _, bench_launches = bench_phase(smi, kind)
    log(f"[phase19] {time.perf_counter() - t0:.1f} s")
    _, dp_launches = dp_phase()

    # Each row's count comes from the path that runs the kernel at the row's
    # shape and type, counters reset just before that path and read just after.
    launches = {"dequantize": main_res["decode_launches"]["dequantize"],
                "score_argmin": main_res["encode_launches"]["score_argmin"],
                "score_argmin_f32": par["scalar"]["launches"]["score_argmin"],
                "nearest_indices": unf["launches"]["nearest_indices"]}
    launches["fused_rb"] = ref_res["encode_launches"]["fused_rb"]
    launches["fused_rb_f32"] = par["scalar_reference"]["launches"]["fused_rb"]
    launches["score_argmin_width32"] = ref_res["encode_launches"]["score_argmin"]
    launches["score_argmin_width128"] = side_res["vec3"]["encode_launches"]["score_argmin"]
    launches["score_argmin_k4096"] = big_res["encode_launches"]["score_argmin"]
    launches["score_argmin_f32_d160"] = deep_res["deep160"]["encode_launches"]["score_argmin"]
    launches["nearest_d160"] = deep_res["deep160_unfused"]["encode_launches"]["nearest_indices"]
    launches["score_argmin_bf16_d1024"] = deep_res["wide1024"]["encode_launches"]["score_argmin"]
    launches["dequantize_bf16_d20"] = deep_res["d20"]["decode_launches"]["dequantize"]
    launches["nearest_indices_train"] = train_res["host_loop"]["launches"]["nearest_indices"]
    launches["dequantize_train"] = train_res["host_loop"]["launches"]["dequantize"]
    # Paths without a kernel row of their own: the mesh's shard steps, the
    # packed_stem model's training and codec and phase 18's one-card meshes;
    # each must have launched too.
    launches["score_argmin_mesh"] = mesh_res["codec"]["v3_encode_launches"]["score_argmin"]
    launches["dequantize_mesh"] = mesh_res["codec"]["decode_launches"]["dequantize"]
    launches["nearest_indices_group_of_one"] = \
        mesh_res["group_of_one"]["train_launches"]["nearest_indices"]
    launches["score_argmin_packed_stem"] = \
        stem_res["round_trip_trained"]["encode_launches"]["score_argmin"]
    launches["nearest_indices_packed_stem_train"] = \
        stem_res["train"]["launches"]["nearest_indices"]
    launches["dequantize_folded_final_conv"] = \
        stem_res["folded_final_conv"]["launches"]["dequantize"]
    # Phase 18's sixteen-entry mesh on one card: 256-row shard steps.
    many = layout_res[f"entries_{LAYOUT_ENTRIES[-1]}"]
    launches["score_argmin_layout"] = many["scalar"]["v3_encode"]["score_argmin"]
    launches["dequantize_layout"] = many["scalar"]["decode"]["dequantize"]
    launches["fused_rb_layout"] = many["scalar_reference"]["v3_encode"]["fused_rb"]
    launches["nearest_indices_layout"] = many["scalar_rvq2"]["v3_encode"]["nearest_indices"]
    # Phase 19's bench: each kernel counted once per capture and eager call
    # (a replayed graph launches without its wrapper).
    for name, count in bench_launches.items():
        launches[f"{name}_bench"] = count
    # Phase 20's data-parallel bench: the reference arch's compress and the
    # decode of its file, on every mesh.
    for name in ("score_argmin", "fused_rb", "dequantize"):
        launches[f"{name}_dp"] = dp_launches[name]
    for row in kernels:
        row["launches"] = launches[row["name"]]
    log(f"[launches] {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on its path")
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
