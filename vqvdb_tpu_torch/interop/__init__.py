"""Interop exports (counterpart of `vqvdb_tpu/interop/`): deploy models into
the reference runtime as torch checkpoints, TorchScript inference modules
and ONNX graphs, plus the numpy ONNX evaluator and the C-header embedder.

The import direction (reference -> port) lives in core/torch_import.py.
"""

from vqvdb_tpu_torch.interop.onnx_export import export_onnx  # noqa: F401
from vqvdb_tpu_torch.interop.torch_export import (  # noqa: F401
    export_state_dict,
    save_reference_checkpoint,
    save_torchscript,
)
