"""portbench: the benchmark of `vqvdb_tpu_torch`, the PyTorch and CUDA codec.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` in a fresh process and prints one JSON
line. Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name the manifest gives:

  configs/<config>.json       the model artifact, its plain-reference module
                              (`reference`), codec settings, CPU pools, chips,
                              mesh, source and departures from it
  traffic/<mix>.json          the parameters of one traffic mix
  limits/<cell>.json          the limits of the cell's output check
  metrics/<metric>.py         the reader of one per-layer metric

The yardstick lives here too: the traffic generator (`frames.py`), the
plain reference (`reference/`: one module an encoder architecture, which
also reads its sizes and counts its encoder's operations; the v3 and v4
readers and writers), the operation and byte counts and the table of peaks
(`counts/`), the trace reduction (`tracing.py`), what the metric readers
share (`readers.py`) and the comparison that decides `correct`
(`checks.py`). `host.py` sizes the program's CPU pools as the configuration
states, before torch is imported. `control.py` takes the readings a cell's
limits are set from; `sets.sh` and `spread.py` measure the spreads its
bounds are set from. None of it imports `jax` or the JAX package, and
`reference/` imports nothing of `vqvdb_tpu_torch`.
"""
