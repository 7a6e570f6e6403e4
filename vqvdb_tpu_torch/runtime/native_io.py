"""ctypes shim over the native host library (counterpart of
`vqvdb_tpu/runtime/native_io.py`): the LZ4 block codec of the v5/v6 frames,
and `copy_into`, the threaded copy that puts a mesh's shard rows back into
their batch. The JAX package's other helpers (`interleave`, `deinterleave`,
`gather_leaves`, `scatter_leaves`) are numpy here: `format/vqvdb.py` packs
and unpacks the v3 records, `vdb/grid.py` moves leaves to and from dense
volumes.

The library is built from the repo's `native/vqvdb_native.cpp` on first use
with `g++ -O3 -shared -fPIC -std=c++17 -pthread` into
`vqvdb_native-<hash>.so` in the kernels' build directory (`ops/build.py`
`BUILD_DIR`; the hash covers the source and the flags, so an edited source
rebuilds). A missing compiler, a failed
build or a failed load raises: there is no second LZ4 implementation to fall
back to, because two valid LZ4 encoders need not give the same bytes and the
port's v5-lz4 files must equal the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from vqvdb_tpu_torch.ops import build as kernel_build

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "vqvdb_native.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return kernel_build.BUILD_DIR / f"vqvdb_native-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found; the native LZ4 codec cannot be built")
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
            lib.vq_version.restype = ctypes.c_int
            lib.vq_copy_mt.argtypes = [u8p, u8p, i64, ctypes.c_int]
            lib.vq_copy_mt.restype = None
            for name in ("vq_lz4_compress", "vq_lz4_decompress"):
                fn = getattr(lib, name)
                fn.argtypes = [u8p, i64, u8p, i64]
                fn.restype = i64
            _lib = lib
        return _lib


def backend() -> str:
    """"native" once the library is built and loaded (else this raises)."""
    _load()
    return "native"


def version() -> int:
    return int(_load().vq_version())


def _p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def lz4_compress(data: bytes) -> bytes:
    """LZ4 block compress (the same encoder as the JAX package's native
    path, so the same bytes)."""
    src = np.frombuffer(data, np.uint8)
    cap = len(data) + len(data) // 255 + 16
    out = np.empty(cap, np.uint8)
    k = _load().vq_lz4_compress(_p(src), len(data), _p(out), cap)
    if k <= 0:
        raise RuntimeError(f"lz4: compressing {len(data)} bytes failed")
    return out[:k].tobytes()


def lz4_decompress(blob: bytes, dst_size: int) -> bytes:
    """LZ4 block decompress to exactly dst_size bytes; raises ValueError on
    malformed input (the decoder is bounds-checked)."""
    src = np.frombuffer(blob, np.uint8)
    out = np.empty(dst_size, np.uint8)
    k = _load().vq_lz4_decompress(_p(src), len(blob), _p(out), dst_size)
    if k != dst_size:
        raise ValueError("lz4: malformed block")
    return out.tobytes()


def copy_into(dst: np.ndarray, src: np.ndarray, threads: int = 0) -> None:
    """dst[...] = src. C-contiguous arrays of one dtype and shape go through
    the library's threaded memcpy (`threads` workers, 0: the hardware's
    count; one below 1 MiB); other layouts take numpy's copy, as in the JAX
    package."""
    lib = _load()
    if (dst.flags.c_contiguous and src.flags.c_contiguous and dst.dtype == src.dtype
            and dst.shape == src.shape):
        lib.vq_copy_mt(_p(src.reshape(-1).view(np.uint8)),
                       _p(dst.reshape(-1).view(np.uint8)), dst.nbytes, threads)
        return
    np.copyto(dst, src)
