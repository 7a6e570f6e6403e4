"""The plain reference of the codec: what `correct` is decided against.

Plain PyTorch and NumPy, in float32 with TF32 off, written from the
architecture and the file formats and not from the program: it imports
neither `jax`, nor the JAX package, nor anything of `vqvdb_tpu_torch`, and
takes none of the program's weights, folds or tables. It reads the same raw
`.vqmodel` artifact the program reads (`vqmodel.py`, a frozen copy of the
format's reader) and reads and writes v3 and v4 `.vqvdb` files (`v3.py`,
`v4.py`). `layers.py` holds the plain layers, the decoder and the
nearest-code search, with an optional operand rounding for the control; one
module an encoder architecture (`packed.py`, `reference.py`, named by a
configuration's "reference") holds its encoder, its sizes as an artifact's
weight shapes give them, and its operation count.
"""

import importlib


def module(name: str):
    """The plain-reference module `reference/<name>.py`."""
    return importlib.import_module(f"{__name__}.{name}")
