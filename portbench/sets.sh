#!/bin/bash
# Full sets of one or more cells: a first run that builds the kernels (not
# counted), two sets of 6 runs on the same 6 seeds, then 3 traced runs.
# Each run's standard output and error go to <out dir>/<cell>.<run>.out / .err;
# `python3 portbench/spread.py <dir>/<cell>.A*.out -- <dir>/<cell>.B*.out`
# then gives the spreads.
# usage: bash portbench/sets.sh <out dir> <seconds> <cell> <seed0> [<cell> <seed0> ...]
out=$1; secs=$2; shift 2
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
run() { local name=$1; shift; local t=$SECONDS
  timeout 400 python3 portbench/run.py "$@" > $out/$name.out 2> $out/$name.err; local rc=$?
  echo "== $name rc=$rc $((SECONDS - t)) s $(tail -n 1 $out/$name.out | cut -c1-400)"
  grep -E "portbench\] cell" $out/$name.err | sed 's/.*set-up/set-up/'; grep -E "FAILED" $out/$name.err || true; }
first=1
while [ $# -gt 0 ]; do
  cell=$1; s0=$2; shift 2
  if [ $first = 1 ]; then
    run $cell.build --workload $cell --seed $((s0 + 99)) --seconds 5 --trace 0
    grep -q '"correct"' $out/$cell.build.out || { echo "the first run gave no result: stop"; exit 1; }
    first=0
  fi
  for set in A B; do for i in 1 2 3 4 5 6; do
    run $cell.$set$i --workload $cell --seed $((s0 + i)) --seconds $secs --trace 0; done; done
  for i in 1 2 3; do run $cell.T$i --workload $cell --seed $((s0 + 10 + i)) --seconds $secs --trace 1; done
done
