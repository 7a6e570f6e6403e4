"""The benchmark: decoded leaves (8^3 blocks) a second on one card, the
counterpart of the JAX package's `bench.py` (the repo root's; `python -m
vqvdb_tpu.cli bench` runs it).

    python -m vqvdb_tpu_torch.cli bench [--device cuda|cpu]
    python -m vqvdb_tpu_torch.bench [--data-parallel] [--device cuda|cpu]

prints one JSON line with the keys of `bench.py`'s line: `metric`
("decode_leaves_per_sec_per_chip"), `value`, `unit`, `vs_baseline`,
`encode_leaves_per_sec_per_chip`, the baseline's median, runs and spread,
`encoder_arch`, `decode_mfu` and `encode_mfu`, and on the card the vec3,
residual-VQ (S=2) and dense-volume rows; then `device` (the card's name, or
"cpu") and `peak_bf16_tflops`, so that every number carries its card.
With `--data-parallel` (the module's entry point only, as in the JAX
package) the line gains `bench.py --data-parallel`'s keys (`DP_KEYS`): the
mesh codec's end-to-end decode rate over every visible card and the host
stages of a data-parallel step (`bench_dp.py`).

Method (`fenced_rate`, the counterpart of `bench.py::_fenced_rate`): the
body `out = step(x); acc += consume(out); x.copy_(perturb(x))` runs on
static buffers. On the card it is warmed up eagerly on a side stream (the
kernels build, cuDNN and cuBLAS make their plans), captured once in a CUDA
graph and replayed lo and hi times, each window from the same input and
fenced by reading `acc` back. The per-step cost is the median of three
(t_hi - t_lo) / (hi - lo) deltas, so a window's fixed cost cancels, and a
replay is one host call, so the rate is the device program's and not the
host's enqueue of its launches. If capture or replay fails it raises;
nothing times the eager loop in its place. On a CPU tensor (the tests) the
body runs eagerly. Perturb and consume are JAX's: (idx + 1) % K for
indices, |x * 0.999 + 1e-4| for leaves, the f32 sum of every output
element.

Rows, as `bench.py` builds them (untrained weights from the port's
initialisers: a rate does not depend on the weights):
  decode / encode  `VQCodec._decode_step` / `_encode_step` in bf16 at batch
                   2,048, encode at the encoder arch of
                   `models/scalar.vqmodel`;
  vec3, rvq2       `ModelConfig(in_channels=3, encoder_arch=<vec3.vqmodel's>)`
                   at batch 1,024, `ModelConfig(num_quantizers=2)` at 2,048;
  dense            `decode_to_dense` of 4 index payloads of a 48^3-block
                   volume fenced by a sum, and `encode_from_dense` 3 times
                   (host clock, the host's uploads and readbacks included);
                   and their device programs (`dense_decode_loop`,
                   `dense_encode_loop`) captured and replayed as above;
  baseline         the reference's execution shape (`baseline_step`):
                   batch 64, f32, the dequantize kernel and the plain
                   decoder (`decoder_pre_tail`, then the tail's three ops
                   unfolded), fresh weights on the card and a fresh capture
                   for each of 3 runs (libraries choose their plans again);
                   the median, with every run and the relative spread.
The whole bench runs with TF32 off in cuDNN and cuBLAS, so f32 is f32.

MFU: rate x analytic MFLOP per leaf x 1e6 over the card's dense bf16 peak,
for the cards in PEAK_BF16_TFLOPS; null elsewhere and on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vqvdb_tpu_torch.core.artifact import load_model_config
from vqvdb_tpu_torch.core.config import LEAF_DIM, CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_from_jax, params_to_jax, resolve_device
from vqvdb_tpu_torch.models.vqvae import decoder_pre_tail, decoder_tail, init_vqvae_params
from vqvdb_tpu_torch.ops.quantize import fused_dequantize
from vqvdb_tpu_torch.parallel.mesh import make_mesh
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.runtime.dense import (
    _blocks_to_dense,
    _pad_steps,
    _scan_scatter,
    _to_blocks,
    decode_to_dense,
    encode_from_dense,
)

REPO_MODELS = Path(__file__).resolve().parent.parent / "models"

# Analytic dense-FLOP cost of the inference graphs per 8^3 leaf, copied from
# the JAX package's bench.py (DECODE_MFLOP_PER_LEAF, ENCODE_MFLOP_PER_LEAF),
# which derives them layer by layer; multiply-add = 2 FLOPs.
DECODE_MFLOP_PER_LEAF = 61.0
ENCODE_MFLOP_PER_LEAF = {
    "reference": 30.0,
    "packed": 32.2,
    "packed_lite": 18.9,
    "packed_stem": 31.2,
}
# Dense bf16 tensor-core peak by `torch.cuda.get_device_name` (NVIDIA's data
# sheet for the H100 SXM part, without sparsity, at its 700 W limit).
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}
BASELINE_RUNS = 3
WARMUP_STEPS = 2  # eager steps before a capture: kernel builds, library plans


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Batch sizes and step counts. A row's `steps` is its hi window; lo is
    steps // 4. On the card each window lasts about 0.2-0.5 s."""

    batch: int  # decode and encode
    decode_steps: int
    encode_steps: int
    baseline_steps: int
    baseline_batch: int = 64
    extra_rows: bool = True  # vec3, rvq2 and the dense rows
    vec3_batch: int = 1024
    vec3_steps: Tuple[int, int] = (128, 256)  # decode, encode
    rvq2_batch: int = 2048
    rvq2_steps: Tuple[int, int] = (256, 128)  # decode, encode
    dense_blocks: Tuple[int, int, int] = (48, 48, 48)  # a 384^3 volume
    dense_batch: int = 2048
    dense_payloads: int = 4
    dense_encode_reps: int = 3
    dense_steps: int = 6
    dp_leaves: int = 100_000  # the file that `data_parallel` decodes


CARD = Sizes(batch=2048, decode_steps=256, encode_steps=256, baseline_steps=96)
# The JAX package's sizes off the TPU; no secondary rows there.
OFF_CARD = Sizes(batch=256, decode_steps=6, encode_steps=4, baseline_steps=24,
                 extra_rows=False, dp_leaves=8_192)
# What `data_parallel` adds to the line: bench.py's keys, in its order.
DP_KEYS = ("mesh_devices", "dp_e2e_decode_leaves_per_sec", "host_shard_ms_per_batch",
           "host_gather_ms_per_batch", "host_gather_shards_ms_per_batch",
           "device_step_ms_per_batch", "host_bound_ceiling_leaves_per_sec",
           "host_bound_ceiling_shards_leaves_per_sec")


def perturb_indices(k: int) -> Callable[[torch.Tensor], torch.Tensor]:
    def perturb(idx):
        return ((idx.to(torch.int32) + 1) % k).to(idx.dtype)
    return perturb


def perturb_leaves(x: torch.Tensor) -> torch.Tensor:
    return (x * 0.999 + 1e-4).abs()


def consume_sum(out) -> torch.Tensor:
    """The f32 sum of every element of a tensor or a tuple of tensors."""
    return sum(t.to(torch.float32).sum() for t in _tensors(out))


def _tensors(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def launches() -> Dict[str, int]:
    """The six kernel wrappers' launch counters."""
    from vqvdb_tpu_torch.ops import quantize as q
    from vqvdb_tpu_torch.ops.decoder_head import decoder_head_fused
    from vqvdb_tpu_torch.ops.fused_rb import residual_block_fused
    from vqvdb_tpu_torch.ops.group_norm import group_norm_relu_fused

    return {"dequantize": q.fused_dequantize.launches,
            "score_argmin": q.fused_score_argmin.launches,
            "nearest_indices": q.fused_nearest_indices.launches,
            "fused_rb": residual_block_fused.launches,
            "group_norm": group_norm_relu_fused.launches,
            "decoder_head": decoder_head_fused.launches}


class FencedLoop:
    """The body `out = step(x); acc += consume(out); x.copy_(perturb(x))` on
    static buffers: x (a copy of x0) and the f32 scalar acc, made in
    inference mode, where the codec's steps run and may update them. On the
    card the body is warmed up on a side stream and captured once in a CUDA
    graph (`launches`: the kernel launches the capture recorded); on the
    CPU it runs eagerly."""

    def __init__(self, step, x0: torch.Tensor, perturb, consume):
        self.step, self.perturb, self.consume = step, perturb, consume
        self.x0 = x0
        self.graph = self.out = None
        self.launches: Dict[str, int] = {}
        with torch.inference_mode():
            self.x = x0.clone()
            self.acc = torch.zeros((), dtype=torch.float32, device=x0.device)
            if x0.device.type == "cuda":
                self._capture()

    def _body(self):
        out = self.step(self.x)
        self.acc += self.consume(out)
        self.x.copy_(self.perturb(self.x))
        return out

    def _capture(self) -> None:
        dev = self.x.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = launches()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self._body()
        self.launches = {k: v - before[k] for k, v in launches().items()}

    def run(self, n: int) -> float:
        """x = x0, acc = 0, then n bodies (graph replays on the card); the
        readback of acc fences them."""
        with torch.inference_mode():
            self.x.copy_(self.x0)
            self.acc.zero_()
            for _ in range(n):
                if self.graph is not None:
                    self.graph.replay()
                else:
                    self._body()
            return self.acc.item()

    def check(self) -> Dict:
        """The replayed body's output from x0 against an eager step on x0
        (card only): bit-equal, and the largest absolute difference."""
        self.run(1)
        with torch.inference_mode():
            ref = _tensors(self.step(self.x0))
            got = _tensors(self.out)
            equal = all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(got, ref))
            diff = max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
                       if a.numel() else 0.0 for a, b in zip(got, ref))
        return {"bit_equal": equal, "max_abs_diff": diff}


def fenced_rate(step, x0: torch.Tensor, steps: int, perturb, consume, *,
                leaves: Optional[int] = None, record: Optional[Dict] = None) -> float:
    """Leaves a second of `step` on x0 (the counterpart of
    `bench.py::_fenced_rate`): `leaves` (default x0's rows) over the median
    of three (t_hi - t_lo) / (hi - lo), hi = steps, lo = steps // 4. On the
    card `record` (if given) receives the capture's launches, the check of
    the replay against the eager step and the marginal ms a step."""
    loop = FencedLoop(step, x0, perturb, consume)
    lo, hi = max(steps // 4, 1), steps
    if record is not None and loop.graph is not None:
        record.update(launches=loop.launches, **loop.check())

    def timed(n):
        t0 = time.perf_counter()
        loop.run(n)
        return time.perf_counter() - t0

    deltas = []
    for _ in range(3):
        t_lo = timed(lo)
        t_hi = timed(hi)
        deltas.append((t_hi - t_lo) / (hi - lo))
    marginal = sorted(deltas)[1]
    if record is not None:
        record.update(ms_per_step=marginal * 1e3, lo=lo, hi=hi)
    return (x0.shape[0] if leaves is None else leaves) / max(marginal, 1e-9)


# ---------------------------------------------------------------------------
# Dense device programs (the counterparts of bench.py's dense_dec_loop and
# dense_enc_loop)
# ---------------------------------------------------------------------------

def dense_decode_loop(codec: VQCodec, indices: np.ndarray, bdims):
    """(step, x0, perturb, consume) of the dense decode's device program:
    every padded step of `indices` (one per block of a `bdims` volume)
    decoded and scattered into a zeroed [nB+1, 512*C] buffer
    (`_scan_scatter`), then the voxel-order transpose (`_blocks_to_dense`,
    a copy) that `decode_to_dense` ends with. Consumed: the buffer's sum and
    one voxel of the volume."""
    dev, bs, c = codec.device, codec.ccfg.batch_size, codec.mcfg.in_channels
    n = int(np.prod(bdims))
    bid_steps = torch.from_numpy(_pad_steps(np.arange(n, dtype=np.int64), bs, n)).to(dev)

    def step(idx_steps):
        buf = torch.zeros((n + 1, LEAF_DIM ** 3 * c), dtype=torch.float32, device=dev)
        _scan_scatter(codec, buf, idx_steps, bid_steps, None, None)
        return buf, _blocks_to_dense(buf, n, bdims, c)

    def consume(out):
        buf, dense = out
        return buf.sum() + dense[0, 0, 0, 0]

    x0 = torch.from_numpy(_pad_steps(indices, bs, 0)).to(dev)
    return step, x0, perturb_indices(codec.mcfg.num_embeddings), consume


def dense_encode_loop(codec: VQCodec, dense: torch.Tensor):
    """(step, x0, perturb, consume) of the dense encode's device program on
    a [X,Y,Z,C] volume: the block rows (`_to_blocks`), the activity
    reduction `encode_from_dense` runs, and every block encoded in steps of
    the codec's batch, with no readback. The last step is padded with the
    last block, which is what the JAX loop's clamped gather reads."""
    dev, bs, c = codec.device, codec.ccfg.batch_size, codec.mcfg.in_channels
    n = int(np.prod([d // LEAF_DIM for d in dense.shape[:3]]))
    bid_steps = torch.from_numpy(_pad_steps(np.arange(n, dtype=np.int64), bs, n - 1)).to(dev)

    def step(vol):
        rows = _to_blocks(vol)
        active = (rows - 0.0).abs().amax(dim=1) > 0.0
        idx = torch.stack([codec._encode_step(
            rows.index_select(0, ids).view(bs, LEAF_DIM, LEAF_DIM, LEAF_DIM, c))
            for ids in bid_steps])
        return idx, active

    return step, dense, perturb_leaves, consume_sum


# ---------------------------------------------------------------------------
# The bench
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def f32_math():
    """TF32 off in cuBLAS and cuDNN for the bench, restored afterwards."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = old


def _arch(name: str) -> str:
    """A committed artifact's encoder arch ("reference" if it is missing)."""
    path = REPO_MODELS / f"{name}.vqmodel"
    return load_model_config(path).encoder_arch if path.exists() else "reference"


def untrained_params(cfg: ModelConfig) -> Dict:
    """Untrained params (the port's initialisers, seed 0) as a JAX-layout
    numpy tree."""
    return params_to_jax(init_vqvae_params(torch.Generator().manual_seed(0), cfg))


def baseline_step(params: Dict, mcfg: ModelConfig, dev) -> Callable:
    """The baseline's decode step on `dev` in f32: [B,4,4,4] indices ->
    the dequantize kernel -> `decoder_pre_tail` -> `decoder_tail` (up_conv,
    pixel shuffle, final conv, head) -> [B,8,8,8,C]. `params` is a
    JAX-layout tree of a single-stage model."""
    p = params_from_jax(params, mcfg, dev)
    dec, book = p["decoder"], p["vq"]["embedding"]

    @torch.inference_mode()
    def step(idx: torch.Tensor) -> torch.Tensor:
        z = fused_dequantize(idx.reshape(-1), book).reshape(
            idx.shape + (mcfg.embedding_dim,))
        return decoder_tail(dec, decoder_pre_tail(dec, z, mcfg), mcfg)
    return step


def _dense_rows(params, mcfg, sz: Sizes, rng, dev, checks) -> Dict[str, float]:
    """The four dense rows (bench.py's): end to end on the host's clock,
    then the device programs."""
    bd = sz.dense_blocks
    n = int(np.prod(bd))
    k = mcfg.num_embeddings
    origins = (np.stack(np.unravel_index(np.arange(n), bd), 1) * LEAF_DIM).astype(np.int32)
    payloads = [rng.integers(0, k, (n,) + mcfg.index_shape).astype(np.uint8)
                for _ in range(sz.dense_payloads)]
    codec = VQCodec(params, mcfg, CodecConfig(batch_size=sz.dense_batch,
                                              compute_dtype="bfloat16"), device=dev)
    out = {}
    decode_to_dense(codec, payloads[0], origins)  # warm-up, untimed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    vols = [decode_to_dense(codec, p, origins)[0] for p in payloads]
    fence = float(sum(v.to(torch.float32).sum() for v in vols))
    dt = time.perf_counter() - t0
    if not np.isfinite(fence):
        raise ArithmeticError(f"dense decode summed to {fence}")
    out["dense_decode_leaves_per_sec"] = round(len(payloads) * n / dt, 1)
    vol = vols[0]
    del vols[1:]

    encode_from_dense(codec, vol)  # warm-up, untimed
    t0 = time.perf_counter()
    for _ in range(sz.dense_encode_reps):
        idx, _ = encode_from_dense(codec, vol)
    dt = time.perf_counter() - t0
    if idx.shape[0] != n:
        raise ArithmeticError(f"dense encode found {idx.shape[0]} of {n} blocks active")
    out["dense_encode_leaves_per_sec"] = round(sz.dense_encode_reps * n / dt, 1)

    for name, (step, x0, perturb, consume) in (
            ("dense_decode_device", dense_decode_loop(codec, payloads[0], bd)),
            ("dense_encode_device", dense_encode_loop(codec, vol))):
        rec = {"row": name}
        out[f"{name}_leaves_per_sec"] = round(fenced_rate(
            step, x0, sz.dense_steps, perturb, consume, leaves=n, record=rec), 1)
        checks.append(rec)
    return out


def run(device=None, checks: Optional[List[Dict]] = None, data_parallel: bool = False,
        **sizes) -> Dict:
    """Measure every row and return the JSON object `main` prints.
    `sizes` override fields of CARD (on the card) or OFF_CARD. `checks`, if
    given, receives a record per fenced row: {"row", and on the card
    "launches" (the capture's), "bit_equal", "max_abs_diff", then
    "ms_per_step", "lo", "hi"}. With `data_parallel` the line gains
    `DP_KEYS`: `bench_dp.bench_mesh_size` over every visible card (a CPU
    mesh of one entry off the card) at the bench's batch and `dp_leaves`
    leaves, bf16 on the card and f32 off it, as `bench.py --data-parallel`."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sz = dataclasses.replace(CARD if on_card else OFF_CARD, **sizes)
    checks = [] if checks is None else checks
    with f32_math():
        out = _run(dev, on_card, sz, checks)
        if data_parallel:
            out.update(_dp_fields(dev, on_card, sz))
    return out


def _dp_fields(dev, on_card: bool, sz: Sizes) -> Dict:
    """bench.py's data-parallel keys, from one `bench_mesh_size` row."""
    from vqvdb_tpu_torch.bench_dp import bench_mesh_size

    mesh = make_mesh(device=dev)
    row = bench_mesh_size(mesh.size, sz.batch, sz.dp_leaves,
                          "bfloat16" if on_card else "float32", dev, mesh)
    out = {"mesh_devices": row["n_devices"],
           "dp_e2e_decode_leaves_per_sec": row["e2e_decode_leaves_per_sec"]}
    out.update((k, row[k]) for k in DP_KEYS[2:])
    return out


def _run(dev, on_card: bool, sz: Sizes, checks: List[Dict]) -> Dict:
    rng = np.random.default_rng(0)
    mcfg = ModelConfig()
    params = untrained_params(mcfg)
    k = mcfg.num_embeddings
    bf16 = dict(compute_dtype="bfloat16")

    def rate(name, step, x0, steps, perturb):
        rec = {"row": name}
        r = fenced_rate(step, x0, steps, perturb, consume_sum, record=rec)
        checks.append(rec)
        return r

    def indices(n, shape):
        return torch.from_numpy(rng.integers(0, k, (n,) + shape).astype(np.uint8)).to(dev)

    def leaves(n, c=1):
        return torch.from_numpy(rng.random((n, 8, 8, 8, c), np.float32)).to(dev)

    # Decode: bf16, the folded decoder tail, batch 2,048.
    codec = VQCodec(params, mcfg, CodecConfig(batch_size=sz.batch, **bf16), device=dev)
    idx = indices(sz.batch, mcfg.index_shape)
    value = rate("decode", codec._decode_step, idx, sz.decode_steps, perturb_indices(k))

    # Encode at the flagship's encoder arch.
    enc_arch = _arch("scalar")
    mcfg_enc = ModelConfig(encoder_arch=enc_arch)
    params_enc = params if enc_arch == "reference" else untrained_params(mcfg_enc)
    enc_codec = VQCodec(params_enc, mcfg_enc, CodecConfig(batch_size=sz.batch, **bf16),
                        device=dev)
    x = leaves(sz.batch)
    encode_value = rate("encode", enc_codec._encode_step, x, sz.encode_steps,
                        perturb_leaves)

    extra = {}
    if sz.extra_rows:
        v3_arch = _arch("vec3")
        mcfg_v3 = ModelConfig(in_channels=3, encoder_arch=v3_arch)
        cdec = VQCodec(untrained_params(mcfg_v3), mcfg_v3,
                       CodecConfig(batch_size=sz.vec3_batch, **bf16), device=dev)
        idx3, leaves3 = indices(sz.vec3_batch, mcfg_v3.index_shape), leaves(sz.vec3_batch, 3)
        extra["vec3_decode_leaves_per_sec"] = round(rate(
            "vec3_decode", cdec._decode_step, idx3, sz.vec3_steps[0], perturb_indices(k)), 1)
        extra["vec3_encode_leaves_per_sec"] = round(rate(
            "vec3_encode", cdec._encode_step, leaves3, sz.vec3_steps[1], perturb_leaves), 1)
        extra["vec3_encoder_arch"] = v3_arch

        mcfg_rvq = ModelConfig(num_quantizers=2)
        crvq = VQCodec(untrained_params(mcfg_rvq), mcfg_rvq,
                       CodecConfig(batch_size=sz.rvq2_batch, **bf16), device=dev)
        idx_rvq = indices(sz.rvq2_batch, mcfg_rvq.index_shape)
        extra["rvq2_decode_leaves_per_sec"] = round(rate(
            "rvq2_decode", crvq._decode_step, idx_rvq, sz.rvq2_steps[0],
            perturb_indices(k)), 1)
        x_rvq = x if sz.rvq2_batch == sz.batch else leaves(sz.rvq2_batch)
        extra["rvq2_encode_leaves_per_sec"] = round(rate(
            "rvq2_encode", crvq._encode_step, x_rvq, sz.rvq2_steps[1], perturb_leaves), 1)
        del cdec, crvq
        extra.update(_dense_rows(params, mcfg, sz, rng, dev, checks))

    # The reference-shaped baseline: batch 64, f32, the tail unfolded; fresh
    # weights and capture each run.
    idx_base = idx[:sz.baseline_batch]
    base_runs = []
    for s in range(BASELINE_RUNS):
        base_runs.append(rate(f"baseline_{s + 1}", baseline_step(params, mcfg, dev), idx_base,
                              sz.baseline_steps, perturb_indices(k)))
    baseline = statistics.median(base_runs)
    spread = (max(base_runs) - min(base_runs)) / baseline if baseline else 0.0

    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peak_tflops = PEAK_BF16_TFLOPS.get(name) if on_card else None
    peak = None if peak_tflops is None else peak_tflops * 1e12
    return {
        "metric": "decode_leaves_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "leaves/s",
        "vs_baseline": round(value / baseline, 2),
        "encode_leaves_per_sec_per_chip": round(encode_value, 1),
        "baseline_leaves_per_sec": round(baseline, 1),
        "baseline_runs": [round(r, 1) for r in base_runs],
        "baseline_spread": round(spread, 3),
        "encoder_arch": enc_arch,
        "decode_mfu": None if peak is None else round(
            value * DECODE_MFLOP_PER_LEAF * 1e6 / peak, 3),
        "encode_mfu": None if peak is None else round(
            encode_value * ENCODE_MFLOP_PER_LEAF[enc_arch] * 1e6 / peak, 3),
        **extra,
        "device": name,
        "peak_bf16_tflops": peak_tflops,
    }


def main(device=None, data_parallel: bool = False, **sizes) -> None:
    """Run the bench on `device` (default cuda) and print its JSON line."""
    print(json.dumps(run(device, data_parallel=data_parallel, **sizes)))


def _cli(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="The decode-throughput benchmark.")
    ap.add_argument("--data-parallel", action="store_true",
                    help="add the mesh codec's end-to-end rate and the host-stage "
                         "cost model (bench_dp.py)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    main(args.device, data_parallel=args.data_parallel)


if __name__ == "__main__":
    _cli()
