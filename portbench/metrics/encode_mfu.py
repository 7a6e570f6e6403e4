"""Encode's share of the cards' bf16 peak: leaves in the window times the plain encoder's operations a leaf."""

from portbench import readers


def read(rec):
    return readers.mfu(rec, "encode")
