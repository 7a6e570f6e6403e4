"""vqvdb_tpu_torch — the VQ-VAE volumetric codec in PyTorch and CUDA.

A port of `vqvdb_tpu` (JAX, TPU) to PyTorch on an NVIDIA Hopper card. The
package never imports JAX or `vqvdb_tpu`; it keeps its own copies of what it
needs. Its layout mirrors the JAX package so each module has a counterpart:

  core/      configs, the `.vqmodel` reader, weight conversion
  models/    blocks, encoder/decoder graphs, quantizer (inference parts)
  ops/       the CUDA kernels' wrappers and their plain versions, folds
  csrc/      the hand-written CUDA kernels (sm_90a)
  format/    `.vqvdb` v3 reader/writer
  vdb/       LeafGrid, PSNR
  runtime/   the streaming codec

Entry points (`VQCodec`, `params_from_jax`) run on `cuda` unless the caller
passes `device="cpu"`; without a card they raise instead of moving to the CPU.
"""

__version__ = "0.1.0"

from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig  # noqa: F401
