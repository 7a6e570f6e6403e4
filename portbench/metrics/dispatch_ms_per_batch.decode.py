"""Host ms the codec's pipeline spends enqueuing a decode batch (runtime/codec.py _pipelined, its device/dispatch stage)."""

from portbench import readers


def read(rec):
    return readers.dispatch_ms_per_batch(rec, "decode")
