"""The per-layer metrics that read the program's own stages
(`readback_wait_ms_per_batch.decode`, `scatter_ms_per_frame.decode`,
`stage_in_ms_per_batch.encode`): a number from the stage's total, nothing for
the other direction or where the program has no such stage (as before it
had them)."""

import pytest

from portbench import harness
from portbench.tests.conftest import run_tiny, tiny_cell

STAGES = {"device/readback_wait": {"total_s": 0.012, "count": 6, "mean_ms": 2.0},
          "host/scatter": {"total_s": 0.09, "count": 9, "mean_ms": 10.0},
          "host/stage_in": {"total_s": 0.003, "count": 2, "mean_ms": 1.5}}
# metric: (its direction, its value from STAGES over 3 frames)
READ = {"readback_wait_ms_per_batch.decode": ("decode", 2.0),
        "scatter_ms_per_frame.decode": ("decode", 30.0),
        "stage_in_ms_per_batch.encode": ("encode", 1.5)}


def record(direction, stages):
    return harness.Record(direction=direction, chips=1, sizes={}, value_bytes=2, peaks=None,
                          frames=3, leaves=300, batches=6, stages=stages)


@pytest.mark.parametrize("name", sorted(READ))
def test_a_reader_reads_its_stage_in_its_direction_alone(name):
    direction, want = READ[name]
    read = harness.metric_reader(name)
    assert read(record(direction, STAGES)) == pytest.approx(want)
    other = "encode" if direction == "decode" else "decode"
    assert read(record(other, STAGES)) is None
    assert read(record(direction, {"device/dispatch": STAGES["host/stage_in"]})) is None


@pytest.mark.parametrize("cell,names", [
    ("scalar.decode_frames", {"readback_wait_ms_per_batch.decode", "scatter_ms_per_frame.decode"}),
    ("scalar.encode_frames", {"stage_in_ms_per_batch.encode"})])
def test_a_traced_run_reports_them(cell, names):
    result = run_tiny(tiny_cell(cell), trace=True)
    assert names <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] >= 0 for n in names)
