"""Where the CUDA kernels and the native LZ4 library are built and cached
(counterpart of `vqvdb_tpu/utils/compile_cache.py`).

The JAX package caches compiled XLA programs across processes; the port's
compiled code is its kernel libraries (`ops/build.py`), one `nvcc` per
`csrc/*.cu`, reused by every later process while the source and flags hash
the same. `enable_persistent_cache()` chooses their directory:

    VQVDB_COMPILE_CACHE unset    vqvdb_tpu_torch/_build/ (the default;
                                 listed in .gitignore)
    VQVDB_COMPILE_CACHE=/path    /path
    VQVDB_COMPILE_CACHE=off      a fresh temporary directory for this
                                 process, removed at exit (returns None)

The JAX package's default is under $XDG_CACHE_HOME; the port keeps its
libraries beside its sources, where earlier processes built them.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

from vqvdb_tpu_torch.ops import build


def enable_persistent_cache() -> Optional[str]:
    """Point the kernel build directory as VQVDB_COMPILE_CACHE says; return
    the persistent directory used, or None when caching is off."""
    loc = os.environ.get("VQVDB_COMPILE_CACHE", "")
    if loc.lower() == "off":
        tmp = tempfile.mkdtemp(prefix="vqvdb_build_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        build.use_build_dir(Path(tmp))
        return None
    cache_dir = Path(loc) if loc else build.PKG_DIR / "_build"
    build.use_build_dir(cache_dir)
    return str(cache_dir)
