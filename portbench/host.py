"""The host side of a cell's deployment, set before torch is imported.

A configuration may state `cpu_threads`: the size of the CPU's thread pools
(OpenMP, MKL, OpenBLAS) the program runs with. Without it the program keeps
torch's default, a thread a core. The program can still choose its own
count: `torch.set_num_threads` in the program overrides this default.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent.parent
POOL_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def workload_arg(argv: List[str]) -> Optional[str]:
    """The value of `--workload` in a command line, or None."""
    for i, a in enumerate(argv):
        if a == "--workload" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--workload="):
            return a.split("=", 1)[1]
    return None


def cpu_threads(workload: str, manifest: Path = ROOT / "BENCHMARK.json") -> Optional[int]:
    """The `cpu_threads` of the cell's configuration, or None."""
    try:
        m = json.loads(manifest.read_text())
        cell = next(w for w in m["workloads"] if w["name"] == workload)
        entry = next(c for c in m["configs"] if c["name"] == cell["config"])
        return json.loads((manifest.parent / entry["file"]).read_text()).get("cpu_threads")
    except (OSError, ValueError, KeyError, StopIteration):
        return None  # the harness names what is missing when it loads the cell


def set_pool(argv: List[str]) -> Optional[int]:
    """Sets the pools' size to the `cpu_threads` of the cell that argv names;
    returns it (None: nothing set)."""
    name = workload_arg(argv)
    n = cpu_threads(name) if name else None
    if n is not None:
        for var in POOL_VARS:
            os.environ[var] = str(n)
    return n
