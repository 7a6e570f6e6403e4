"""The spread of a cell's runs, from which the bounds of its end-to-end
metrics are set.

    python3 portbench/spread.py <result files of set A> -- <result files of set B>

Each file holds a run's standard output; its last line is the result. For
each metric: each set's median and spread (the distance between the first
and the third quartile of `statistics.quantiles(values, n=4)`, as a share of
the median), the wider spread, five times it (the bound it suggests, between
0.01 and 0.25), and how far set B's median lies from set A's. Beside them,
as a check of a bound reads them: `tight`, the mean of the two sets'
spreads with each set's run farthest from its median left out (a bound is
too tight where this is over half of it), `loose`, the spread of all runs
together (a bound is too loose where it is over eight times this), and the
manifest's bound with both verdicts.
"""

import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List


def values(files: List[str]) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    for f in files:
        line = json.loads(Path(f).read_text().strip().splitlines()[-1])
        for k, v in line["metrics"].items():
            out.setdefault(k, []).append(v["value"])
    return out


def spread(xs: List[float]) -> float:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / q2


def without_farthest(xs: List[float]) -> List[float]:
    """xs without the value farthest from their median."""
    m = statistics.median(xs)
    far = max(range(len(xs)), key=lambda i: abs(xs[i] - m))
    return xs[:far] + xs[far + 1:]


def bounds(manifest: Path = Path(__file__).resolve().parent.parent / "BENCHMARK.json"):
    try:
        return {e["name"]: e["bound"] for e in json.loads(manifest.read_text())["end_to_end"]}
    except (OSError, ValueError, KeyError):
        return {}


def main(argv: List[str]) -> int:
    cut = argv.index("--")
    a, b = values(argv[:cut]), values(argv[cut + 1:])
    bound = bounds()
    for k in a:
        sa, sb = spread(a[k]), spread(b[k])
        ma, mb = statistics.median(a[k]), statistics.median(b[k])
        tight = (spread(without_farthest(a[k])) + spread(without_farthest(b[k]))) / 2
        loose = spread(a[k] + b[k])
        row = {"metric": k, "median_a": ma, "median_b": mb, "spread_a": sa, "spread_b": sb,
               "suggested_bound": min(0.25, max(0.01, 5 * max(sa, sb))),
               "b_vs_a": mb / ma - 1, "tight": tight, "loose": loose}
        if k in bound:
            row.update(bound=bound[k], too_tight=tight > bound[k] / 2,
                       too_loose=bound[k] > 0.01 and bound[k] > 8 * loose)
        print(json.dumps({**row, "a": a[k], "b": b[k]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
