"""% of the traced encode window in which a card ran no kernel, copy or fill (mean over the cards)."""

from portbench import readers


def read(rec):
    return readers.idle_share(rec, "encode")
