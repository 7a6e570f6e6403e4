"""The port's `.vqmodel` reader and msgpack decoder against the JAX package.

Every committed artifact must load to arrays bit-equal to what flax's own
msgpack decoder restores from it (the decoder under
`vqvdb_tpu.core.artifact.load_model`), and the flagship to arrays bit-equal
to `load_model`'s itself (that loader builds a JAX init template per
architecture, seconds each, so it runs once). Every truncation must raise
ArtifactError (not struct.error).
"""

from pathlib import Path

import jax
import msgpack
from flax import serialization
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.artifact import load_model as jax_load_model
from vqvdb_tpu_torch.core import msgpack_lite
from vqvdb_tpu_torch.core.artifact import load_model, load_model_config
from vqvdb_tpu_torch.core.weights import params_from_jax
from vqvdb_tpu_torch.utils.errors import ArtifactError

torch.set_num_threads(2)

MODELS = sorted((Path(__file__).parent.parent / "models").glob("*.vqmodel"))
FLAGSHIP = Path(__file__).parent.parent / "models" / "scalar.vqmodel"


def _flatten(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _assert_same_arrays(tree, ref_tree):
    ours, ref = _flatten(tree), _flatten(ref_tree)
    assert ours.keys() == ref.keys()
    for key, arr in ref.items():
        assert ours[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(ours[key], arr, err_msg=key)


@pytest.mark.parametrize("path", MODELS, ids=[p.stem for p in MODELS])
def test_artifact_matches_flax_decoder(path):
    tree, cfg = load_model(path)
    raw = path.read_bytes()
    cfg_len = int.from_bytes(raw[8:12], "little")
    assert load_model_config(path) == cfg
    assert cfg.encoder_arch in raw[12:12 + cfg_len].decode()
    _assert_same_arrays(tree, serialization.msgpack_restore(raw[12 + cfg_len + 8:]))


def test_flagship_matches_jax_loader():
    tree, cfg = load_model(FLAGSHIP)
    jparams, jcfg = jax_load_model(FLAGSHIP)
    assert cfg.__dict__ == jcfg.__dict__
    _assert_same_arrays(tree, jax.tree.map(np.asarray, jparams._asdict()))


def _cut_points(raw: bytes):
    cfg_len = int.from_bytes(raw[8:12], "little")
    blob_at = 12 + cfg_len + 8
    return {
        "magic": 5,
        "config_length": 10,
        "config_block": 12 + cfg_len // 2,
        "params_length": 12 + cfg_len + 3,
        "params_blob": blob_at + (len(raw) - blob_at) // 2,
        "last_byte": len(raw) - 1,
    }


@pytest.mark.parametrize("where", ["magic", "config_length", "config_block",
                                   "params_length", "params_blob", "last_byte"])
def test_truncated_artifact_raises(tmp_path, where):
    raw = FLAGSHIP.read_bytes()
    cut = tmp_path / "cut.vqmodel"
    cut.write_bytes(raw[: _cut_points(raw)[where]])
    with pytest.raises(ArtifactError):
        load_model(cut)
    if where in ("magic", "config_length", "config_block"):
        with pytest.raises(ArtifactError):
            load_model_config(cut)


def test_bad_magic_and_malformed_blob_raise(tmp_path):
    raw = FLAGSHIP.read_bytes()
    bad = tmp_path / "bad.vqmodel"
    bad.write_bytes(b"VQMODEL2" + raw[8:])
    with pytest.raises(ArtifactError):
        load_model(bad)
    p_at = 12 + int.from_bytes(raw[8:12], "little")
    p_len = int.from_bytes(raw[p_at:p_at + 8], "little")
    head, blob = raw[:p_at], raw[p_at + 8:]
    # A blob whose declared length matches but whose msgpack object is cut.
    bad.write_bytes(head + (p_len - 7).to_bytes(8, "little") + blob[:-7])
    with pytest.raises(ArtifactError):
        load_model(bad)
    # A blob with a stray byte after the msgpack object.
    bad.write_bytes(head + (p_len + 1).to_bytes(8, "little") + blob + b"\x00")
    with pytest.raises(ArtifactError):
        load_model(bad)


def test_msgpack_lite_matches_msgpack():
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33,
                 -128, -129, -32768, -32769, -2**31 - 1],
        "floats": [0.5, -1.25e-3, 1e300],
        "str": "x" * 40, "long": "y" * 300, "bin": b"\x00\x01" * 200,
        "nested": {"a": None, "b": True, "c": False, "list": list(range(20))},
        "wide": {str(i): i for i in range(20)},
    }
    packed = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed, raw=False)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(packed[:-1])
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(packed + b"\x00")


def test_msgpack_lite_decodes_flax_ext_types():
    """flax's ndarray (ext 1) and numpy-scalar (ext 3) leaves, several
    dtypes and ranks; a complex leaf (ext 2) is not taken."""
    state = {
        "f32": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        "f64": np.linspace(-1.0, 1.0, 7),
        "i8": np.array([-3, 7], np.int8), "u16": np.zeros((0, 5), np.uint16),
        "scalar": np.float32(2.5), "count": np.int64(-7), "step": 3,
    }
    raw = serialization.msgpack_serialize(state)
    _assert_same_arrays(msgpack_lite.unpackb(raw), serialization.msgpack_restore(raw))
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))


def test_params_from_jax_layouts():
    tree, cfg = load_model(FLAGSHIP)
    p = params_from_jax(tree, cfg, device="cpu")
    w = tree["encoder"]["stem_conv"]["w"]  # DHWIO
    np.testing.assert_array_equal(
        p["encoder"]["stem_conv"]["w"].numpy(), np.transpose(w, (4, 3, 0, 1, 2)))
    np.testing.assert_array_equal(p["decoder"]["attn"]["fc1"]["w"].numpy(),
                                  tree["decoder"]["attn"]["fc1"]["w"])
    np.testing.assert_array_equal(p["vq"]["embedding"].numpy(),
                                  tree["vq"]["embedding"])
    assert p["decoder"]["stem_gn"]["scale"].shape == (64,)
