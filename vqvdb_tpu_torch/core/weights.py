"""JAX parameter trees -> the port's tensors, and the device rule.

The JAX package stores convs as DHWIO `(kd, kh, kw, in, out)`, linears as
`(in, out)`, GroupNorm as `scale`/`bias` and the codebook as `vq.embedding`
`(K, D)`, or `(S, K, D)` for an S-stage residual-VQ model. The port keeps the same nested-dict tree with torch tensors:
convs become OIDHW (the reverse of `vqvdb_tpu/core/torch_import.py`'s
transpose), stored channels-last so cuDNN runs them in NDHWC; every other
leaf keeps its shape. `params_to_jax` is the way back, for the model
artifact and the codec.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.utils.errors import ConfigError

Params = Dict[str, Any]
DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another. Without a card, anything but an explicit CPU request raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported device {dev}")
    return dev


def tree_to_torch(node: Any, device: torch.device) -> Any:
    """Any JAX-layout subtree -> f32 tensors on `device` (convs to OIDHW)."""
    if hasattr(node, "_asdict"):  # VQState and other NamedTuples
        node = node._asdict()
    if isinstance(node, dict):
        out = {k: tree_to_torch(v, device) for k, v in node.items()}
        w = out.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 5:
            out["w"] = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
        return out
    return torch.from_numpy(np.array(node, dtype=np.float32)).to(device)


def params_from_jax(tree: Params, cfg: ModelConfig,
                    device: DeviceLike = None) -> Params:
    """Convert a JAX-layout params tree (numpy arrays, as
    `jax.tree.map(np.asarray, params._asdict())` or `core.artifact.load_model`
    give it) into f32 torch tensors on `device`."""
    dev = resolve_device(device)
    out = tree_to_torch(tree, dev)
    emb = out["vq"]["embedding"]
    want = (cfg.num_embeddings, cfg.embedding_dim)
    if cfg.num_quantizers > 1:  # residual-VQ: one codebook per stage
        want = (cfg.num_quantizers,) + want
    if tuple(emb.shape) != want:
        raise ConfigError(
            f"codebook shape {tuple(emb.shape)} != config {want}")
    return out


def params_to_jax(node: Any) -> Any:
    """The port's params tree -> the JAX layout as numpy arrays (convs back
    to DHWIO, every leaf C-contiguous in its own dtype), keys in the tree's
    order."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "w" and isinstance(v, torch.Tensor) and v.dim() == 5:
                v = v.permute(2, 3, 4, 1, 0)
            out[k] = params_to_jax(v)
        return out
    return np.ascontiguousarray(node.detach().cpu().numpy())
