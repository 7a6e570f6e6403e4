"""Readings from which a cell's output limits are set: the program's numbers
over many seeds (the lower readings) and the control's (the upper ones).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3]

For each seed, in one process: the seed's inputs, every frame once through
the codec call the timed window makes (as the warm-up does), then each
checked frame through it again, judged by `checks.py` against the plain
reference. The control is the reference itself in the program's place,
computed one precision below the configuration's bfloat16: every operand of
every product rounded to float8 e4m3 (`reference/layers.py::fp8`). It has to
come out as not correct. Prints one JSON line a reading, {"seed", "side":
"program" | "control", "numbers"}, and a last line with each number's
largest program reading and smallest control reading.
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import host  # noqa: E402

host.set_pool(sys.argv[1:])  # as run.py runs the program

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import checks, harness  # noqa: E402
from portbench.reference import vqmodel  # noqa: E402


def readings(cell: harness.Cell, seeds, control_seeds, device: torch.device):
    """Yield {"seed", "side", "numbers"} for the program on `seeds` and the
    control on `control_seeds`."""
    params, model_cfg = vqmodel.load(harness.ROOT / cell.config["model"])
    codec = harness.make_codec(cell, device)
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    control = harness.reference_model(params, model_cfg, cell.config, device, "fp8")
    for seed in dict.fromkeys(list(seeds) + list(control_seeds)):
        work = Path(tempfile.mkdtemp(prefix="portbench-control-"))
        try:
            inputs = harness.Inputs(cell, seed, device, work)
            watch = harness.checked_frames(cell.traffic, seed)
            if seed in seeds:
                kept = {}
                for f in list(range(len(inputs.sizes))) + watch:
                    if inputs.direction == "decode":
                        kept[f] = codec.decompress(inputs.paths[f])[0][0]
                    else:
                        grid = LeafGrid(name=inputs.name, origins=inputs.origins[f],
                                        leaves=inputs.leaves[f])
                        kept[f] = work / f"checked{f:02d}.vqvdb"
                        codec.compress(grid, kept[f],
                                       format_version=cell.traffic["format_version"])
                kept = {f: kept[f] for f in watch}
                yield {"seed": seed, "side": "program",
                       "numbers": harness.check(cell, inputs, kept, params, model_cfg, device)}
            if seed in control_seeds:
                yield {"seed": seed, "side": "control",
                       "numbers": control_numbers(cell, inputs, watch, params, model_cfg,
                                                  control, device)}
        finally:
            shutil.rmtree(work, ignore_errors=True)


@torch.inference_mode()
def control_numbers(cell, inputs, watch, params, model_cfg, control, device):
    """The comparison numbers with the control's outputs in the program's place."""
    model = harness.reference_model(params, model_cfg, cell.config, device)
    tally = checks.Tally(inputs.direction)
    for f in watch:
        if inputs.direction == "decode":
            o, idx = harness.read_frame(inputs.paths[f])
            leaves = torch.cat([control.decode(checks.indices_tensor(idx[s:s + checks.BLOCK], device)).cpu()
                                for s in range(0, idx.shape[0], checks.BLOCK)])
            checks.decode_frame(tally, model, o, idx, o, leaves.numpy(), device)
        else:
            o = inputs.origins[f]
            checks.encode_frame(tally, model, inputs.leaves[f], o, o,
                                np.zeros((o.shape[0], 4, 4, 4), np.uint8),
                                device, control=control)
    return tally.numbers()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda")
    harness.say(f"card {torch.cuda.get_device_name(0)}, power limit {harness.card_power()}")
    worst = {"program": {}, "control": {}}
    for r in readings(cell, args.seeds, args.control_seeds, device):
        print(json.dumps(r), flush=True)
        pick = max if r["side"] == "program" else min
        for k, v in r["numbers"].items():
            worst[r["side"]][k] = pick(worst[r["side"]].get(k, v), v)
    print(json.dumps({"workload": cell.name, "program_largest": worst["program"],
                      "control_smallest": worst["control"],
                      "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
