"""Device kernel ms per 4,096-leaf decode batch, summed over the cards (models/, ops/ and the kernels)."""

from portbench import readers


def read(rec):
    return readers.device_ms_per_batch(rec, "decode")
