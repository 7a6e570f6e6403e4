"""Whether each stage of the codec's steps gives a row the same bits in
batches of other sizes.

    python -m vqvdb_tpu_torch.tools.batch_invariance [--model models/scalar.vqmodel]
                                                     [--device cuda|cpu]

A mesh cuts each batch into shards, one per device, so its files equal one
device's only where every stage computes a row independently of how many
rows share its batch. This runs 4,096 seeded leaves through each stage of
the flagship's encode and decode steps whole and in row blocks of 2,048,
1,024 and 512, in bf16 and f32 (TF32 off), and prints one JSON object:
{dtype: {stage: {block rows: bit-equal}}}, with `fc_matmul` (the channel
attention's fc as one cuBLAS product) beside `fc_row_blocks` (the port's
products in blocks of rows, `models/blocks.py::row_blocks`), and
`tail_one_gemm` (the tail as one product) beside `tail` (`ops/tail.py`,
in the same blocks). On the card
it also times each of those two pairs on the 4,096 rows (CUDA events, in
turns: the port's form, the single product, the single product, the port's
form; "ms") and prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.models import blocks, vqvae
from vqvdb_tpu_torch.ops.packed import space_to_channel
from vqvdb_tpu_torch.ops.tail import apply_decoder_tail
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.train.synthetic import smoke_grid

REPO = Path(__file__).resolve().parent.parent.parent
BLOCKS = (2048, 1024, 512)


def _invariant(fn, x):
    """{block rows: fn(x) equal bit for bit to fn over x's row blocks}."""
    with torch.inference_mode():
        whole = fn(x)
        return {n: bool(torch.equal(whole, torch.cat([fn(x[i:i + n])
                                                       for i in range(0, x.shape[0], n)])))
                for n in BLOCKS}


def stages(model: Path, device: str, n: int = 4096) -> dict:
    tree, cfg = load_model(model)
    pool = smoke_grid(160, seed=0).leaves
    leaves = pool[np.arange(n) % pool.shape[0]]
    out = {}
    for dtype in ("bfloat16", "float32"):
        codec = VQCodec(tree, cfg, CodecConfig(compute_dtype=dtype), device=device)
        enc, dec = codec.params["encoder"], codec.params["decoder"]
        x = torch.from_numpy(leaves).to(codec.device)
        h = blocks.conv3d(enc["stem_conv"], space_to_channel(x.to(codec.dtype), 2), padding=1)
        y = h.to(torch.float32).mean(dim=(1, 2, 3))
        w = enc["attn"]["fc1"]["w"].to(torch.float32)
        idx = codec._encode_step(x)
        z = vqvae.decoder_pre_tail(dec, codec._codebook[idx.reshape(-1).long()].reshape(
            (n,) + cfg.latent_shape + (cfg.embedding_dim,)), cfg)
        k = codec._folded_tail["k"].to(z.dtype).to(torch.float32)
        r = {
            "encoder_stem_conv": _invariant(
                lambda t: blocks.conv3d(enc["stem_conv"], t, padding=1),
                space_to_channel(x.to(codec.dtype), 2)),
            "group_norm": _invariant(lambda t: blocks.group_norm(enc["stem_gn"], t, 8), h),
            "residual_block": _invariant(lambda t: blocks.residual_block(enc["rb"], t), h),
            "attention_mean": _invariant(lambda t: t.to(torch.float32).mean(dim=(1, 2, 3)), h),
            "fc_matmul": _invariant(lambda t: t @ w, y),
            "fc_row_blocks": _invariant(lambda t: blocks.row_blocks(t, w), y),
            "channel_attention": _invariant(lambda t: blocks.channel_attention(enc["attn"], t),
                                            h),
            "tail_one_gemm": _invariant(lambda t: t.reshape(t.shape[0], -1).to(torch.float32)
                                        @ k, z),
            "tail": _invariant(lambda t: apply_decoder_tail(codec._folded_tail, t, cfg), z),
            "encode_step": _invariant(codec._encode_step, x),
            "decode_step": _invariant(codec._decode_step, idx),
        }
        if codec.device.type == "cuda":
            attn = enc["attn"]

            def attention_matmul(t):
                a = torch.relu(t.to(torch.float32).mean(dim=(1, 2, 3))
                               @ attn["fc1"]["w"].to(torch.float32))
                a = torch.sigmoid(a @ attn["fc2"]["w"].to(torch.float32))
                return t * a[:, None, None, None, :].to(t.dtype)

            pairs = {"channel_attention": (lambda: blocks.channel_attention(attn, h),
                                           lambda: attention_matmul(h)),
                     "tail": (lambda: apply_decoder_tail(codec._folded_tail, z, cfg),
                              lambda: z.reshape(n, -1).to(torch.float32) @ k)}
            r["ms"] = {name: dict(zip(("port", "one_product", "one_product_again",
                                       "port_again"),
                                      (_cuda_ms(f) for f in (a, b, b, a))))
                       for name, (a, b) in pairs.items()}
        out[dtype] = r
    return out


def _cuda_ms(fn, iters: int = 30) -> float:
    with torch.inference_mode():
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", type=Path, default=REPO / "models" / "scalar.vqmodel")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(stages(args.model, args.device)))
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
