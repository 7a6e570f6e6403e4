"""vqvdb_tpu_torch — the VQ-VAE volumetric codec in PyTorch and CUDA.

A port of `vqvdb_tpu` (JAX, TPU) to PyTorch on an NVIDIA Hopper card. The
package never imports JAX or `vqvdb_tpu`; it keeps its own copies of what it
needs. Its layout mirrors the JAX package so each module has a counterpart:

  core/      configs, the `.vqmodel` reader, weight conversion
  models/    blocks, encoder/decoder graphs, quantizer (inference parts)
  ops/       the CUDA kernels' wrappers and their plain versions, folds
  csrc/      the hand-written CUDA kernels (sm_90a)
  format/    `.vqvdb` v3-v6 reader/writer, transcode, verify
  vdb/       LeafGrid, PSNR, OpenVDB `.vdb` reader/writer and blosc
  runtime/   the streaming codec, the dense device paths, the v6 residual
             math, the LZ4 shim
  api.py     the high-level calls; cli.py the command line
             (`python -m vqvdb_tpu_torch.cli`)

Entry points (`VQCodec`, `api.make_codec`, the CLI, `params_from_jax`) run
on `cuda` unless the caller passes `device="cpu"`; without a card they
raise instead of moving to the CPU.
"""

__version__ = "0.1.0"

from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig  # noqa: F401
