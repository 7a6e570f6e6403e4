"""Where the fused residual block's time goes, on one CUDA card.

    python3 -m vqvdb_tpu_torch.tools.rb_phases [--leaves 4096]

Builds `csrc/fused_rb_tc.cu` four times: whole, without the MMAs
(-DVQ_RB_SKIP_MMA: the ldmatrix reads, GroupNorm, loads and stores stay),
without the GroupNorm statistics (-DVQ_RB_SKIP_GN: no shuffles, reductions
or their barriers; normalise, split and plane stores stay), and MMAs only
(-DVQ_RB_SKIP_LDSM -DVQ_RB_SKIP_GN: no shared-memory reads of A, no
statistics; the MMAs, plane stores, loads and stores stay).
Each variant is timed with bf16 and f32 x of --leaves leaves, as the mean of
100 launches replayed from a CUDA graph, with the weights already in the
kernel's layout (the wrapper's two small stacking ops are not timed). Only
the whole kernel's output means anything; it is checked against the plain
version. Then `tools/mma_rate.cu` measures what the tensor cores give each
instruction shape the kernel could use: mma.sync m16n8k16 and wgmma
m64nNk16 for N = 16, 32, 48, 64 (A from registers, B from shared memory),
bf16 with f32 sums, back to back on every SM. Prints one JSON object per dtype and
one for the rates, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from vqvdb_tpu_torch.ops import build
from vqvdb_tpu_torch.ops.fused_rb import residual_block_plain

VARIANTS = {"kernel": (), "no_mma": ("-DVQ_RB_SKIP_MMA",), "no_gn": ("-DVQ_RB_SKIP_GN",),
            "mma_only": ("-DVQ_RB_SKIP_LDSM", "-DVQ_RB_SKIP_GN")}
RATE_SHAPES = ("mma_sync_m16n8k16", "wgmma_m64n16k16", "wgmma_m64n32k16", "wgmma_m64n48k16",
               "wgmma_m64n64k16")
TOOLS = Path(__file__).resolve().parent


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Mean device time of fn(), replayed from a CUDA graph of `launches`."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def _compile(workdir: Path):
    """nvcc for every variant and for mma_rate.cu, all started together."""
    nvcc = build.find_nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {name: (build.CSRC_DIR / "fused_rb_tc.cu", defs) for name, defs in VARIANTS.items()}
    jobs["mma_rate"] = (TOOLS / "mma_rate.cu", ())
    procs = {name: subprocess.Popen(
        [nvcc, *flags, *defs, "-o", str(workdir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, defs) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        libs[name] = ctypes.CDLL(str(workdir / f"{name}.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in VARIANTS:
        libs[name].vq_residual_block16.argtypes = [p, i, p, p, p, p, i, i, f, f, p]
        libs[name].vq_residual_block16.restype = i
    libs["mma_rate"].vq_mma_rate.argtypes = [i, i, p, p]
    libs["mma_rate"].vq_mma_rate.restype = i
    libs["mma_rate"].vq_mma_rate_flops.argtypes = [i, i]
    libs["mma_rate"].vq_mma_rate_flops.restype = ctypes.c_double
    return libs


def _params(dev, gen):
    t = lambda *s, scale: scale * torch.randn(*s, device=dev, generator=gen)
    conv = lambda: {"w": t(16, 16, 3, 3, 3, scale=0.05), "b": t(16, scale=0.1)}
    gn = lambda: {"scale": 1 + t(16, scale=0.1), "bias": t(16, scale=0.1)}
    return {"gn1": gn(), "conv1": conv(), "gn2": gn(), "conv2": conv()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--leaves", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rb_phases: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    n = args.leaves
    with tempfile.TemporaryDirectory() as tmp:
        libs = _compile(Path(tmp))
        gen = torch.Generator(device=dev).manual_seed(0)
        p = _params(dev, gen)
        convs = [p["conv1"], p["conv2"]]
        w = torch.stack([c["w"].permute(2, 3, 4, 1, 0) for c in convs]).contiguous()
        prm = torch.stack([p["gn1"]["scale"], p["gn1"]["bias"], p["conv1"]["b"],
                           p["gn2"]["scale"], p["gn2"]["bias"], p["conv2"]["b"]])
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(n, 8, 8, 8, 16, device=dev, generator=gen).to(dtype)
            out = torch.empty_like(x)

            def launch(lib):
                status = lib.vq_residual_block16(
                    x.data_ptr(), int(dtype == torch.bfloat16), w[0].data_ptr(),
                    w[1].data_ptr(), prm.data_ptr(), out.data_ptr(), n, 8, 0.1, 1e-5,
                    torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"launch failed: {status}")

            launch(libs["kernel"])
            want = residual_block_plain(p, x, 8, 0.1)
            err = (out.float() - want.float()).abs().max().item()
            tol = 2e-5 if dtype == torch.float32 else 3e-2
            if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
                raise AssertionError(f"{dtype}: max abs err {err} beyond {tol}")
            row = {"x_dtype": str(dtype).split(".")[1], "leaves": n, "max_abs_err": err}
            for name in VARIANTS:
                row[f"{name}_ms"] = graph_ms(lambda lib=libs[name]: launch(lib))
            print(json.dumps(row), flush=True)
        rates = {}
        lib = libs["mma_rate"]
        sink = torch.empty(torch.cuda.get_device_properties(dev).multi_processor_count * 384,
                           device=dev)
        for shape, name in enumerate(RATE_SHAPES):
            def run(shape=shape):
                status = lib.vq_mma_rate(shape, 4096, sink.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"mma_rate {name}: launch failed: {status}")

            ms = graph_ms(run, launches=5, replays=2)
            rates[f"{name}_tflops"] = lib.vq_mma_rate_flops(shape, 4096) / (ms * 1e-3) / 1e12
        print(json.dumps(rates), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
