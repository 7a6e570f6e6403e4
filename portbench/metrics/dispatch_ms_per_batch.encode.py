"""Host ms the codec's pipeline spends enqueuing an encode batch (runtime/codec.py _pipelined, its device/dispatch stage)."""

from portbench import readers


def read(rec):
    return readers.dispatch_ms_per_batch(rec, "encode")
