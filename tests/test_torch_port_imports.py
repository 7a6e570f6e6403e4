"""The port stands alone: every module of `vqvdb_tpu_torch` imports in a
fresh interpreter where `jax` and the JAX package cannot be imported, and
none of it loads a `vqvdb_tpu.` module. (The card's machine has no JAX.)"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "vqvdb_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import vqvdb_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(vqvdb_tpu_torch.__path__,
                                                     "vqvdb_tpu_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith(("jax.", "vqvdb_tpu.")))
                and sys.modules[m] is not None)
print(len(names), " ".join(names))
print("LEAKED", leaked)
"""


def test_every_port_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count_names, leaked = out.stdout.strip().splitlines()[-2:]
    names = count_names.split()[1:]
    for want in ("vqvdb_tpu_torch.cli", "vqvdb_tpu_torch.api",
                 "vqvdb_tpu_torch.vdb.openvdb_io", "vqvdb_tpu_torch.vdb.blosc",
                 "vqvdb_tpu_torch.runtime.dense", "vqvdb_tpu_torch.runtime.codec",
                 "vqvdb_tpu_torch.ops.quantize", "vqvdb_tpu_torch.format.vqvdb",
                 "vqvdb_tpu_torch.train.train", "vqvdb_tpu_torch.train.fast",
                 "vqvdb_tpu_torch.train.data", "vqvdb_tpu_torch.train.synthetic",
                 "vqvdb_tpu_torch.train.checkpoint", "vqvdb_tpu_torch.eval.metrics",
                 "vqvdb_tpu_torch.eval.report", "vqvdb_tpu_torch.serving",
                 "vqvdb_tpu_torch.utils.profiler", "vqvdb_tpu_torch.utils.compile_cache",
                 "vqvdb_tpu_torch.core.torch_import", "vqvdb_tpu_torch.interop",
                 "vqvdb_tpu_torch.interop.torch_module", "vqvdb_tpu_torch.interop.torch_export",
                 "vqvdb_tpu_torch.interop.onnx_proto", "vqvdb_tpu_torch.interop.onnx_export",
                 "vqvdb_tpu_torch.interop.onnx_eval", "vqvdb_tpu_torch.interop.embed",
                 "vqvdb_tpu_torch.integrations.houdini", "vqvdb_tpu_torch.parallel",
                 "vqvdb_tpu_torch.parallel.mesh", "vqvdb_tpu_torch.parallel.distributed",
                 "vqvdb_tpu_torch.ops.subpixel", "vqvdb_tpu_torch.bench",
                 "vqvdb_tpu_torch.bench_dp", "vqvdb_tpu_torch.tools.roundtrip",
                 "vqvdb_tpu_torch.integrations.hdk", "vqvdb_tpu_torch.tools.install_check"):
        assert want in names
    assert leaked == "LEAKED []"
