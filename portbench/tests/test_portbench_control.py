"""The control at a size a test run holds: the reference one precision below
the configuration's bfloat16 (float8 operands) in the program's place fails
the cell's limits, and the program on the same seed passes them."""

import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import checks
from portbench.tests.conftest import tiny_cell

BENCH = Path(__file__).resolve().parent.parent


def _control_module():
    spec = importlib.util.spec_from_file_location("portbench_control", BENCH / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["scalar.decode_frames", "vec3.decode_frames",
                                  "scalar.encode_frames"])
def test_the_control_fails_and_the_program_passes(name):
    cell = tiny_cell(name)
    seed = 2**31 + 5
    got = {r["side"]: r["numbers"] for r in
           _control_module().readings(cell, [seed], [seed], torch.device("cpu"))}
    assert checks.judge(got["program"], cell.limits)[0], got["program"]
    assert not checks.judge(got["control"], cell.limits)[0], got["control"]
