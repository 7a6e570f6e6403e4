"""The score-argmin kernel's share of its roofline (csrc/score_argmin_tc.cu; features, score matrix and indices once; 2 N F K operations)."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "encode", "score_argmin_kernel", readers.score_argmin_work)
