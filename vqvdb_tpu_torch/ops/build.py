"""Build, load and launch the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by its own `nvcc` process
(all started together) into `vqvdb_tpu_torch/_build/<name>-<hash>.so` and
loaded with ctypes. The hash covers the source and the flags, so an edited
kernel rebuilds and an unchanged one is reused. The sources have a plain C
interface: every entry point takes pointers and the stream as `void*`,
sizes as `int`, and returns `cudaGetLastError()` after its launch.

A missing `nvcc`, a failed build or a failed load raises; nothing falls
back to another implementation. `call` launches an entry point on the
current stream and raises on a launch error; `on_card` and `require` are
the wrappers' shared input checks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("dequantize", "score_argmin_tc", "fused_rb_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> (source, argument types before the trailing stream)
ENTRY_POINTS = {
    "vq_dequantize": ("dequantize", (_P, _I, _P, _P, _I, _I, _I)),
    "vq_score_argmin": ("score_argmin_tc", (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I)),
    "vq_nearest_indices": ("score_argmin_tc", (_P, _P, _P, _P, _P, _I, _I, _I, _I)),
    "vq_residual_block16": ("fused_rb_tc", (_P, _I, _P, _P, _P, _P, _I, _I, _F, _F)),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Tuple[ctypes.CDLL, object]] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build() -> Dict[str, str]:
    """Compile every kernel source whose library is missing, one nvcc
    process per source, all started together. Returns {name: nvcc output,
    which holds the ptxas report} for the sources it compiled."""
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, _target(name))
        reports[name] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building every kernel source
    first if this one is not built yet."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build()
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def _entry(name: str):
    if name not in _entries:
        libname, argtypes = ENTRY_POINTS[name]
        lib = library(libname)
        fn = getattr(lib, name)
        fn.argtypes = [*argtypes, _P]
        fn.restype = ctypes.c_int
        lib.vq_error_string.argtypes = [ctypes.c_int]
        lib.vq_error_string.restype = ctypes.c_char_p
        _entries[name] = (lib, fn)
    return _entries[name]


def call(name: str, device: torch.device, *args) -> None:
    """Launch entry point `name` on the current stream of `device`; raise
    if the launch reports an error."""
    lib, fn = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(*args, stream)
    if status != 0:
        msg = lib.vq_error_string(status).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({status})")


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every tensor
    is on the CPU; raise otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
