"""The fused residual block kernel's share of its roofline (csrc/fused_rb_tc.cu, the
reference encoders' RB(16) over 8^3; counts/fused_rb.py: both convs' operations, each
leaf read and written once, the weights once a launch)."""

from portbench import readers
from portbench.counts import fused_rb


def read(rec):
    return readers.roofline(rec, "encode", "rb16_tc_kernel", fused_rb.work)
