"""Reader and writer of `VQMODEL1` model artifacts (counterpart of
`vqvdb_tpu/core/artifact.py`).

Layout (little-endian):
    magic   b"VQMODEL1"
    u32     config JSON length, then JSON bytes
    u64     params msgpack length, then flax.serialization bytes

The params come back as a nested dict of numpy arrays, keyed as the JAX
package's `VQVAEParams._asdict()` (encoder / decoder / vq). Every
truncation — header, config block or params blob — raises ArtifactError.
`save_model` writes the port's params tree in the JAX layout: for the same
params, the same bytes as the JAX package's `save_model`.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import BinaryIO, Dict, Tuple, Union

from vqvdb_tpu_torch.core import msgpack_lite
from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.weights import params_to_jax
from vqvdb_tpu_torch.utils.errors import ArtifactError

MAGIC = b"VQMODEL1"


def save_model(path: Union[str, Path], params: Dict, cfg: ModelConfig) -> None:
    """Write the port's params tree (torch tensors, as training makes them)
    and `cfg` as a `.vqmodel`."""
    cfg_json = json.dumps(dataclasses.asdict(cfg)).encode("utf-8")
    params_bytes = msgpack_lite.packb(params_to_jax(params))
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(cfg_json)))
        f.write(cfg_json)
        f.write(struct.pack("<Q", len(params_bytes)))
        f.write(params_bytes)


def _read_exact(f: BinaryIO, n: int, what: str) -> bytes:
    raw = f.read(n)
    if len(raw) != n:
        raise ArtifactError(
            f"model artifact truncated: {what} needs {n} bytes, got {len(raw)}")
    return raw


def _read_config(f: BinaryIO, path) -> ModelConfig:
    if f.read(len(MAGIC)) != MAGIC:
        raise ArtifactError(f"not a vqvdb model artifact: {path}")
    (cfg_len,) = struct.unpack("<I", _read_exact(f, 4, "config length"))
    raw = _read_exact(f, cfg_len, "config block")
    try:
        return ModelConfig(**json.loads(raw.decode("utf-8")))
    except (UnicodeDecodeError, json.JSONDecodeError, TypeError, ValueError) as e:
        raise ArtifactError(f"bad model config block in {path}: {e}") from e


def load_model_config(path: Union[str, Path]) -> ModelConfig:
    """Read just the ModelConfig block (skips the params blob)."""
    with open(path, "rb") as f:
        return _read_config(f, path)


def load_model(path: Union[str, Path]) -> Tuple[Dict, ModelConfig]:
    """(params as nested dict of numpy arrays, ModelConfig)."""
    with open(path, "rb") as f:
        cfg = _read_config(f, path)
        (p_len,) = struct.unpack("<Q", _read_exact(f, 8, "params length"))
        raw = _read_exact(f, p_len, "params blob")
    try:
        tree = msgpack_lite.unpackb(raw)
    except ValueError as e:
        raise ArtifactError(f"bad params blob in {path}: {e}") from e
    if not (isinstance(tree, dict)
            and {"encoder", "decoder", "vq"} <= set(tree)):
        raise ArtifactError(
            f"params blob in {path} lacks encoder/decoder/vq entries")
    return tree, cfg
