"""The dequantize kernel's share of its roofline (csrc/dequantize.cu; bytes-bound: indices, codebook and bf16 rows once)."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "decode", "dequantize_kernel", readers.dequantize_work)
