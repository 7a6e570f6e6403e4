"""Whether each stage of the codec's steps gives a row the same bits in
batches of other sizes, and what the fixed-shape blocks cost.

    python -m vqvdb_tpu_torch.tools.batch_invariance [--device cuda|cpu]
                                                     [--leaves 4096] [--rates LEAVES]

A mesh cuts each batch into shards, one per device, so its files equal one
device's only where every stage computes a row independently of how many
rows share its batch. This runs --leaves seeded leaves through each stage
of the encode and decode steps of the flagship (`models/scalar.vqmodel`),
the reference arch (`scalar_reference`) and the residual-VQ model
(`scalar_rvq2`) whole and in row blocks of 2,048, 1,024, 512 and 256
leaves (the shards of a 4,096-leaf batch on 2 to 16 devices), in bf16 and
f32 (TF32 off), the six kernels included (each block its own launch; the
`group_norm_relu` stages run the GroupNorm kernel on the card, the eager
`group_norm` stages its plain version; the `tail` stage is the decode step's
head, fed by the decoder's trunk: the head kernel on the card), and prints
one JSON object:

  "stages":      {model: {dtype: {stage: {block rows: bit-equal}}}}: the
                 port's forms, which must all be true;
  "single_call": the same for a whole-batch call of the flagship's
                 attention fc, tail GEMM and decoder stem conv, which the
                 port runs in fixed-shape blocks (`models/blocks.py::row_wise`)
                 because these move;
  "ms" (card):   the device time (torch.profiler, kernel durations summed),
                 the wall time (CUDA events) and the host's enqueue time
                 (median, a sync after each call) of the flagship's bf16
                 encode and decode steps on --leaves leaves with the blocks
                 of ROW_BLOCK["cuda"] = 256, 512 and 1,024 rows and with one
                 block of the whole batch (one call per op, the form before
                 the blocks), in turns: whole, 1024, 512, 256, 256, 512,
                 1024, whole;
  "rates" (with --rates N): compress and decompress leaves/s of the
                 flagship's default codec on N leaves with the same forms,
                 in the same turns.

On the card it then prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.models import blocks, vqvae
from vqvdb_tpu_torch.ops.decoder_head import decoder_head_fused
from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused
from vqvdb_tpu_torch.ops.packed import space_to_channel
from vqvdb_tpu_torch.ops.quantize import (
    fused_dequantize,
    fused_nearest_indices,
    fused_score_argmin,
)
from vqvdb_tpu_torch.ops.tail import fold_decoder_tail
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.train.synthetic import smoke_grid
from vqvdb_tpu_torch.vdb.grid import LeafGrid

REPO = Path(__file__).resolve().parent.parent.parent
MODELS = ("scalar", "scalar_reference", "scalar_rvq2")
BLOCKS = (2048, 1024, 512, 256)
TIMED_BLOCKS = (None, 1024, 512, 256)  # None: one block of the whole batch


def _invariant(fn, x, sizes=BLOCKS):
    """{block rows: fn(x) equal bit for bit to fn over x's row blocks}."""
    with torch.inference_mode():
        whole = fn(x)
        return {n: bool(torch.equal(whole, torch.cat([fn(x[i:i + n])
                                                       for i in range(0, x.shape[0], n)])))
                for n in sizes}


def _leaves(n: int) -> np.ndarray:
    pool = smoke_grid(160, seed=0).leaves
    return pool[np.arange(n) % pool.shape[0]]


def _flagship(codec, x, sizes):
    cfg = codec.mcfg
    enc, dec = codec.params["encoder"], codec.params["decoder"]
    out, single = {}, {}
    with torch.inference_mode():
        packed = space_to_channel(x.to(codec.dtype), 2)
        h = torch.relu(blocks.group_norm(enc["stem_gn"], blocks.conv3d(
            enc["stem_conv"], packed, padding=1), 8))
        y = blocks.channel_mean(h)
        w = enc["attn"]["fc1"]["w"].to(torch.float32)
        feats = codec._features(x.to(codec.dtype))
        idx = codec._encode_step(x)
        z = codec._codebook[idx.reshape(-1).long()].reshape(
            idx.shape + (cfg.embedding_dim,))
        trunk = vqvae.decoder_trunk(dec, z, cfg)
        pre = vqvae.decoder_pre_tail(dec, z, cfg)
        k = fold_decoder_tail(dec, cfg)["k"].to(pre.dtype).to(torch.float32)
    stem_w = dec["stem_conv"]["w"].to(z.dtype)
    stem_b = dec["stem_conv"]["b"].to(z.dtype)
    out["encoder_stem_conv"] = _invariant(
        lambda t: blocks.conv3d(enc["stem_conv"], t, padding=1), packed, sizes)
    out["group_norm"] = _invariant(lambda t: blocks.group_norm(enc["stem_gn"], t, 8), h, sizes)
    out["group_norm_relu"] = _invariant(
        lambda t: blocks.group_norm_relu(enc["stem_gn"], t, 8), h, sizes)
    out["residual_block"] = _invariant(lambda t: blocks.residual_block(enc["rb"], t), h, sizes)
    out["attention_mean"] = _invariant(blocks.channel_mean, h, sizes)
    out["attention_fc"] = _invariant(lambda t: blocks.row_blocks(t, w), y, sizes)
    out["channel_attention"] = _invariant(
        lambda t: blocks.channel_attention(enc["attn"], t), h, sizes)
    out["score_argmin"] = _invariant(
        lambda t: fused_score_argmin(t.reshape(-1, t.shape[-1]), codec._score_prep),
        feats, sizes)
    out["dequantize"] = _invariant(
        lambda t: fused_dequantize(t.reshape(-1), codec._codebook), idx, sizes)
    out["decoder_stem_conv"] = _invariant(
        lambda t: blocks.conv3d(dec["stem_conv"], t, padding=1), z, sizes)
    out["tail"] = _invariant(lambda t: decoder_head_fused(codec._head, t, cfg), trunk, sizes)
    single["attention_fc_one_product"] = _invariant(lambda t: t @ w, y, sizes)
    single["tail_one_gemm"] = _invariant(
        lambda t: t.reshape(t.shape[0], -1).to(torch.float32) @ k, pre, sizes)
    single["decoder_stem_one_conv"] = _invariant(
        lambda t: torch.nn.functional.conv3d(t.permute(0, 4, 1, 2, 3), stem_w, stem_b,
                                             padding=1), z, sizes)
    return out, single, idx


def _reference(codec, x, sizes):
    enc, folded = codec.params["encoder"], codec._folded_down
    out = {}
    with torch.inference_mode():
        xd = x.to(codec.dtype)
        h1 = blocks.conv3d(enc["pre_conv"], xd, padding=1)
        h2 = blocks.group_norm_relu(enc["pre_gn"], h1, 4).contiguous()
        h3 = residual_block_fused(enc["pre_rb"], h2)
    out["pre_conv"] = _invariant(lambda t: blocks.conv3d(enc["pre_conv"], t, padding=1),
                                 xd, sizes)
    out["pre_group_norm"] = _invariant(lambda t: blocks.group_norm(enc["pre_gn"], t, 4),
                                       h1, sizes)
    out["pre_group_norm_relu"] = _invariant(
        lambda t: blocks.group_norm_relu(enc["pre_gn"], t, 4), h1, sizes)
    out["fused_rb"] = _invariant(lambda t: residual_block_fused(enc["pre_rb"], t), h2, sizes)
    out["folded_down_conv"] = _invariant(
        lambda t: blocks.conv3d(folded, space_to_channel(t, 2), padding=1), h3, sizes)
    return out


def _rvq(codec, x, sizes):
    cfg = codec.mcfg
    with torch.inference_mode():
        z = vqvae.encoder_apply(codec.params["encoder"], x.to(codec.dtype), cfg)
        flat = z.to(torch.float32)
    return {"nearest_indices": _invariant(
        lambda t: fused_nearest_indices(t.reshape(-1, cfg.embedding_dim),
                                        codec._stage_prep[0]), flat, sizes)}


def stages(device: str, n: int = 4096, sizes=BLOCKS) -> dict:
    """{"stages": ..., "single_call": ...} on `n` leaves (see the module doc)."""
    x_np = _leaves(n)
    out = {"stages": {}, "single_call": {}}
    for name in MODELS:
        tree, cfg = load_model(REPO / "models" / f"{name}.vqmodel")
        res = out["stages"][name] = {}
        for dtype in ("bfloat16", "float32"):
            codec = VQCodec(tree, cfg, CodecConfig(compute_dtype=dtype), device=device)
            x = torch.from_numpy(x_np).to(codec.device)
            if name == "scalar":
                r, out["single_call"][dtype], idx = _flagship(codec, x, sizes)
            else:
                r = (_reference if name == "scalar_reference" else _rvq)(codec, x, sizes)
                with torch.inference_mode():
                    idx = codec._encode_step(x)
            r["encode_step"] = _invariant(codec._encode_step, x, sizes)
            r["decode_step"] = _invariant(codec._decode_step, idx, sizes)
            res[dtype] = r
    return out


@contextlib.contextmanager
def _card_block(rows):
    """ROW_BLOCK["cuda"] = rows inside (None: the caller's whole batch)."""
    old = blocks.ROW_BLOCK["cuda"]
    blocks.ROW_BLOCK["cuda"] = rows or old
    try:
        yield
    finally:
        blocks.ROW_BLOCK["cuda"] = old


def _device_ms(fn, arg, iters: int = 10) -> dict:
    """Mean per call of fn(arg): kernel durations summed (torch.profiler),
    the CUDA events' elapsed time, and the host's time to enqueue a call
    (outside the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(arg)
    torch.cuda.synchronize()
    host = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(arg)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn(arg)
        end.record()
        end.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"device_ms": dev_us / 1e3 / iters, "event_ms": start.elapsed_time(end) / iters,
            "host_enqueue_ms": float(np.median(host)) * 1e3}


def _turns():
    return TIMED_BLOCKS + TIMED_BLOCKS[::-1]


def step_times(n: int = 4096) -> dict:
    """The flagship's bf16 encode and decode steps on n leaves per block
    size, in turns: {"whole"|rows: [{"encode": {...}, "decode": {...}}, ...]}."""
    tree, cfg = load_model(REPO / "models" / "scalar.vqmodel")
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=n), device="cuda")
    x = torch.from_numpy(_leaves(n)).cuda()
    with torch.inference_mode():
        idx = codec._encode_step(x)
    out: dict = {}
    for rows in _turns():
        with _card_block(rows or n):
            out.setdefault(rows or "whole", []).append(
                {"encode": _device_ms(codec._encode_step, x),
                 "decode": _device_ms(codec._decode_step, idx)})
    return out


def rates(n_leaves: int) -> dict:
    """compress / decompress leaves/s of the flagship's default codec on
    n_leaves leaves per block size, in turns."""
    tree, cfg = load_model(REPO / "models" / "scalar.vqmodel")
    codec = VQCodec(tree, cfg, CodecConfig(), device="cuda")
    pool = smoke_grid(160, seed=0)
    sel = np.arange(n_leaves) % pool.num_leaves
    grid = LeafGrid("density", (np.stack(np.unravel_index(np.arange(n_leaves),
                                                          (64, 64, 64)), 1) * 8).astype(np.int32),
                    pool.leaves[sel])
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rate.vqvdb"
        codec.compress(grid, path)
        codec.decompress(path)
        for rows in _turns():
            with _card_block(rows or codec.ccfg.batch_size):
                cs = codec.compress(grid, path)
                _, ds = codec.decompress(path)
            out.setdefault(rows or "whole", []).append(
                {"compress": cs["leaves_per_sec"], "decompress": ds["leaves_per_sec"]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--leaves", type=int, default=4096)
    ap.add_argument("--rates", type=int, default=0, metavar="LEAVES")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = stages(args.device, args.leaves)
    out["seconds"] = time.perf_counter() - t0
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        out["ms"] = step_times(args.leaves)
        if args.rates:
            out["rates"] = rates(args.rates)
    out["row_block"] = blocks.ROW_BLOCK[torch.device(args.device).type]
    print(json.dumps(out))
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
