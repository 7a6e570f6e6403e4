"""How far the f32 decodes sit from an f64 decode of the same indices.

    python -m vqvdb_tpu_torch.tools.decode_error [--model models/scalar.vqmodel]
                                                 [--device cuda|cpu]

Takes the leaves `export-onnx` validates with (4 seeded leaves), encodes
them with `encode_to_indices` and decodes those indices four ways: in f64
(the reference: every op in float64, NCDHW), with `decode_from_indices`
(the stem conv as per-tap projected codebooks), with the codec's graph
`decoder_apply` of the looked-up codewords (the direct f32 stem conv), and
with the exported decoder.onnx under the numpy evaluator. Then it replaces
one stage of the f64 decode at a time by the port's f32 op on the same
input, to show which stage's rounding reaches the output. Prints one JSON
object of max abs errors, then (on the card) the card's name and power
limit. f32 convs run with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.weights import params_from_jax
from vqvdb_tpu_torch.interop.onnx_eval import run_model
from vqvdb_tpu_torch.interop.onnx_export import build_decoder_onnx
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.models.vqvae import (
    decode_from_indices,
    decoder_apply,
    encode_to_indices,
)

REPO = Path(__file__).resolve().parent.parent.parent


def _f64(node):
    if isinstance(node, dict):
        return {k: _f64(v) for k, v in node.items()}
    return node.double().contiguous()


def _stages(dec, cfg):
    """The decoder as (name, f64 op on NCDHW, the port's f32 op on NDHWC)."""
    nc, cl = (lambda t: t.permute(0, 4, 1, 2, 3)), (lambda t: t.permute(0, 2, 3, 4, 1))

    def conv(p, x):
        return F.conv3d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2)

    def gn_relu(p, x):
        return torch.relu(F.group_norm(x, 8, p["scale"], p["bias"], 1e-5))

    def port(fn):
        return lambda p32, x: nc(fn(p32, cl(x.float()))).double()

    out = [("stem_conv", lambda p, x: conv(p["stem_conv"], x),
            port(lambda p, x: blocks.conv3d(p["stem_conv"], x, padding=1))),
           ("stem_gn", lambda p, x: gn_relu(p["stem_gn"], x),
            port(lambda p, x: torch.relu(blocks.group_norm(p["stem_gn"], x, 8))))]
    def residual(p, x):
        h = conv(p["conv1"], gn_relu(p["gn1"], x))
        return x + 0.1 * conv(p["conv2"], gn_relu(p["gn2"], h))

    for rb in (("rb",) if cfg.variant == "scalar" else ("rb1", "rb2")):
        out.append((rb, lambda p, x, rb=rb: residual(p[rb], x),
                    port(lambda p, x, rb=rb: blocks.residual_block(p[rb], x))))

    def attn(p, x):
        y = x.mean(dim=(2, 3, 4))
        y = torch.sigmoid(torch.relu(y @ p["attn"]["fc1"]["w"]) @ p["attn"]["fc2"]["w"])
        return x * y[:, :, None, None, None]

    def up(p, x):
        h = conv(p["up_conv"], x)
        b, c, d, hh, w = h.shape
        return h.view(b, c // 8, 2, 2, 2, d, hh, w).permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(
            b, c // 8, 2 * d, 2 * hh, 2 * w)

    act = torch.sigmoid if cfg.variant == "scalar" else torch.tanh
    out += [("attn", attn, port(lambda p, x: blocks.channel_attention(p["attn"], x))),
            ("up_conv_shuffle", up, port(lambda p, x: blocks.pixel_shuffle_3d(
                blocks.conv3d(p["up_conv"], x, padding=1), 2))),
            ("final_conv", lambda p, x: conv(p["final"], x),
             port(lambda p, x: blocks.conv3d(p["final"], x, padding=1))),
            ("head", lambda p, x: act(x), lambda p, x: act(x.float()).double())]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default=str(REPO / "models" / "scalar.vqmodel"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tree, cfg = load_model(args.model)
    params = params_from_jax(tree, cfg, args.device)
    dev = params["vq"]["embedding"].device
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    x = np.random.default_rng(0).random((4, 8, 8, 8, cfg.in_channels), np.float32)
    p32, p64 = params["decoder"], _f64(params["decoder"])
    stages = _stages(p32, cfg)
    with torch.no_grad():
        idx = encode_to_indices(params, torch.from_numpy(x).to(dev), cfg)
        flat = idx.long().reshape(idx.shape[0], *cfg.latent_shape, cfg.num_quantizers)
        books = params["vq"]["embedding"].reshape(cfg.num_quantizers, cfg.num_embeddings, -1)
        z32 = sum(books[s][flat[..., s]] for s in range(cfg.num_quantizers))
        z64 = sum(books[s].double()[flat[..., s]] for s in range(cfg.num_quantizers))

        def decode64(f32_stage=None):
            h = z64.permute(0, 4, 1, 2, 3)
            for name, op64, op32 in stages:
                h = op32(p32, h) if name == f32_stage else op64(p64, h)
            return h.permute(0, 2, 3, 4, 1)

        ref = decode64()
        ways = {"decode_from_indices": decode_from_indices(params, idx, cfg),
                "direct_f32_stem": decoder_apply(p32, z32, cfg)}
        out = {"model": Path(args.model).name, "device": str(dev)}
        out.update({f"{k}_vs_f64": float((v.double() - ref).abs().max()) for k, v in ways.items()})
        onnx = None
        if cfg.num_quantizers == 1:
            got = run_model(build_decoder_onnx(tree, cfg), {"input": idx.cpu().numpy()})["output"]
            onnx = torch.from_numpy(np.moveaxis(got, 1, -1)).to(dev)
            out["onnx_numpy_vs_f64"] = float((onnx.double() - ref).abs().max())
            out.update({f"{k}_vs_onnx": float((v - onnx).abs().max()) for k, v in ways.items()})
        out["one_f32_stage_in_f64_vs_f64"] = {
            name: float((decode64(name) - ref).abs().max()) for name, _, _ in stages}
    print(json.dumps(out))
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
