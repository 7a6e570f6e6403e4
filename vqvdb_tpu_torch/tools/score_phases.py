"""Where the score-argmin kernel's time goes, on one CUDA card.

    python3 -m vqvdb_tpu_torch.tools.score_phases [--rows 262144] [--codes 256]

Builds `csrc/score_argmin_tc.cu` four times: whole, without the argmin
epilogue (-DVQ_SKIP_EPILOGUE), without the MMAs (-DVQ_SKIP_MMA) and without
both (tile loads and barriers only). Each variant is timed at F = 32, 64, 128
with bf16 rows and F = 64, 128 with f32 rows, as the mean of 100 launches
replayed from a CUDA graph (no host time between launches; the rows stay in
L2 from one launch to the next). Also timed: one launch of 128 rows (launch,
M into shared memory, one tile) and `addmm` + `argmin`. Only the whole
kernel's indices mean anything; it is checked against the plain version.
Prints one JSON object per shape, then the card's name and power limit.
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

from vqvdb_tpu_torch.ops import build, quantize as q

VARIANTS = {"kernel": (), "mma_only": ("-DVQ_SKIP_EPILOGUE",),
            "epilogue_only": ("-DVQ_SKIP_MMA",),
            "loads_only": ("-DVQ_SKIP_MMA", "-DVQ_SKIP_EPILOGUE")}
SHAPES = ((32, torch.bfloat16), (64, torch.bfloat16), (128, torch.bfloat16),
          (64, torch.float32), (128, torch.float32))


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


def build_variants(workdir: Path):
    nvcc = build.find_nvcc()
    src = build.CSRC_DIR / "score_argmin_tc.cu"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {name: subprocess.Popen(
        [nvcc, *flags, *defs, "-o", str(workdir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vq_score_argmin.argtypes = [p, i, p, p, p, p, i, i, i, i, p]
        lib.vq_score_argmin.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=262144)
    ap.add_argument("--codes", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("score_phases: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n, k = args.rows, args.codes
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for f, dtype in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(f)
            h = torch.randn(n, f, device=dev, generator=gen).to(dtype)
            m = torch.randn(f, k, device=dev, generator=gen)
            c = torch.randn(k, device=dev, generator=gen)
            prep = q.prepare_scores(m, c)
            out = torch.empty(n, dtype=torch.int32, device=dev)
            best = torch.empty(n, dtype=torch.float32, device=dev)

            def launch(lib, rows=n):
                status = lib.vq_score_argmin(
                    h.data_ptr(), int(dtype == torch.bfloat16), prep.operand.data_ptr(),
                    prep.c_tiles.data_ptr(), out.data_ptr(), best.data_ptr(), rows, f, k,
                    prep.tile, torch.cuda.current_stream().cuda_stream)
                if status:
                    raise RuntimeError(f"launch failed: {status}")

            launch(libs["kernel"])
            scores = h.float() @ m + c
            two = torch.topk(scores, 2, dim=1, largest=False).values
            off = (out.long() != scores.argmin(1)) & (two[:, 1] - two[:, 0] > 1e-5 * two[:, 0].abs())
            if off.any():
                raise AssertionError(f"F={f} {dtype}: {int(off.sum())} rows differ off near-ties")
            row = {"f": f, "rows_dtype": str(dtype).split(".")[1], "n": n, "k": k}
            for name, lib in libs.items():
                row[f"{name}_ms"] = graph_ms(lambda lib=lib: launch(lib))
            row["one_tile_launch_ms"] = graph_ms(lambda: launch(libs["kernel"], 128))
            hf = h.float()
            row["addmm_argmin_ms"] = graph_ms(lambda: torch.addmm(c, hf, m).argmin(1))
            print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
