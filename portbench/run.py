"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The program's CPU pools take the size the cell's configuration states
(`cpu_threads`, `host.py`), set before torch is imported. Exits 2 without a result when
there is no CUDA card, or fewer cards than the cell asks for, and 3 when
`sys.modules` holds JAX or the JAX package once the window has closed. Otherwise the last line on standard output is
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device and, traced, breakdown; "check" (each compared number beside its
limit) comes last, and the same numbers close standard error.
"""

import os
import sys
import time


def _started() -> float:
    """The process's start on the perf_counter clock (from /proc; the
    interpreter's start-up included)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _started()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import host  # noqa: E402

host.set_pool(sys.argv[1:])

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.say(f"cell {cell.name} needs {cell.chips} CUDA card(s); this machine has {have}")
        return 2
    smi = harness.card_power()
    harness.say(f"card {torch.cuda.get_device_name(0)}, power limit {smi}; rooflines and MFU "
                "are shares of the published H100 SXM peaks (counts/peaks.json); CPU pool "
                f"{torch.get_num_threads()} thread(s)")
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda"), T0)
    bad = harness.forbidden_modules()
    if bad:
        harness.say(f"the process loaded {bad}: no module of JAX or the JAX package may run")
        return 3
    rows = result.pop("_rows")
    print(json.dumps(result), flush=True)
    for r in rows:
        harness.say(f"check {r['name']} = {r['value']!r} limit {r['limit']!r} "
                    f"{'ok' if r['ok'] else 'FAILED'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
