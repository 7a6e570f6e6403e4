"""The plain reference of the codec: what `correct` is decided against.

Plain PyTorch and NumPy, in float32 with TF32 off, written from the
architecture and the file formats and not from the program: it imports
neither `jax`, nor the JAX package, nor anything of `vqvdb_tpu_torch`, and
takes none of the program's weights, folds or tables. It reads the same raw
`.vqmodel` artifact the program reads (`vqmodel.py`, a frozen copy of the
format's reader) and reads and writes v3 `.vqvdb` files (`v3.py`).
`model.py` holds the encoder and decoder forward passes and the nearest-code
search, with an optional operand rounding for the control.
"""
