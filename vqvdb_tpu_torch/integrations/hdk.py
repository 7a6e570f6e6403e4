"""The compiled Houdini SOPs' command lines, in Python.

`hdk/SOP_VQVDB.cpp` (vqvdb::encoder / vqvdb::decoder) cooks by running
the executable named in its "vqvdb Executable" parameter on a temp-file
`.vdb` bridge: it builds one shell command line and runs it through
`popen(line + " 2>&1")`, keeping the exit status and the combined output
(the node's error message). This module builds the same lines, so the
port's executable can be driven exactly as the plugin drives it:

    cmd = write_launcher("vqvdb-torch", bin_dir)   # what pip installs
    line = encode_line(cmd, "in.vdb", "out.vqvdb", batch=4096,
                       grid="density", model="models/scalar.vqmodel")
    status, output = run_line(line)

`quoted` is the plugin's POSIX branch (`SOP_VQVDB.cpp:61-82`);
`encode_line` and `decode_line` build its two command lines (`:160-164`,
`:240-243`).
`write_launcher` writes the console script that `pip install` generates
for an entry of `pyproject.toml`'s `[project.scripts]` (`vqvdb-torch =
"vqvdb_tpu_torch.cli:main"`): pip's template, byte for byte, under a
`#!` line naming this interpreter.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

PathLike = Union[str, Path]

PYPROJECT = Path(__file__).resolve().parent.parent.parent / "pyproject.toml"
RESIDUAL_FLAGS = {0: "", 1: " --residual int8", 2: " --residual f16"}  # Off, Int8, Half
# pip's console-script template (pip._internal.operations.install.wheel.PipScriptMaker)
LAUNCHER_TEMPLATE = """\
import sys
from {module} import {import_name}
if __name__ == '__main__':
    sys.argv[0] = sys.argv[0].removesuffix('.exe')
    sys.exit({func}())
"""
MAX_SHEBANG = 127  # bytes of a `#!` line the Linux kernel reads
VDB_UUID = slice(21, 57)  # a .vdb header's random 36-character UUID (vdb/openvdb_io.py)


def quoted(value: PathLike) -> str:
    """One shell word holding `value` verbatim: single quotes disable every
    expansion, and an embedded ' becomes '\\''."""
    return "'" + str(value).replace("'", "'\\''") + "'"


def encode_line(cmd: PathLike, bridge: PathLike, out: PathLike, batch: int = 4096,
                grid: str = "density", model: PathLike = "", residual: int = 0) -> str:
    """The encoder SOP's line; an empty `grid` or `model` is left out, as
    the node leaves out an empty parameter. `residual` is the menu's
    ordinal: 0 Off, 1 Int8, 2 Half."""
    line = (f"{quoted(cmd)} encode {quoted(bridge)} {quoted(out)} "
            f"--batch-size {int(batch)}")
    if grid:
        line += " --grid " + quoted(grid)
    if model:
        line += " --model " + quoted(model)
    return line + RESIDUAL_FLAGS[residual]


def decode_line(cmd: PathLike, vqvdb: PathLike, bridge: PathLike, batch: int = 4096,
                grid: str = "", model: PathLike = "") -> str:
    """The decoder SOP's line (its grid parameter defaults to empty)."""
    line = (f"{quoted(cmd)} decode {quoted(vqvdb)} {quoted(bridge)} "
            f"--batch-size {int(batch)}")
    if grid:
        line += " --grid " + quoted(grid)
    if model:
        line += " --model " + quoted(model)
    return line


def run_line(line: str, env: Optional[Dict[str, str]] = None,
             timeout: Optional[float] = None) -> Tuple[int, str]:
    """Run `line` as popen does, `/bin/sh -c "<line> 2>&1"`: (the exit
    status, stdout and stderr as one text)."""
    proc = subprocess.run(["/bin/sh", "-c", line + " 2>&1"], stdout=subprocess.PIPE,
                          env=env, timeout=timeout)
    return proc.returncode, proc.stdout.decode(errors="replace")


def console_scripts(pyproject: PathLike = PYPROJECT) -> Dict[str, str]:
    """`[project.scripts]` of a pyproject.toml: {name: "module:function"}."""
    import tomllib

    with open(pyproject, "rb") as f:
        return dict(tomllib.load(f)["project"]["scripts"])


def shebang(python: str) -> str:
    """The `#!` lines pip writes for `python`: the path itself, or, when
    it holds a space or is too long for the kernel, a /bin/sh trampoline."""
    if " " not in python and len(python) + 3 <= MAX_SHEBANG:
        return f"#!{python}\n"
    python = f'"{python}"' if " " in python else python
    return f"#!/bin/sh\n'''exec' {python} \"$0\" \"$@\"\n' '''\n"


def write_launcher(name: str, bin_dir: PathLike, pyproject: PathLike = PYPROJECT,
                   python: str = sys.executable) -> Path:
    """Write the console script of entry `name` into `bin_dir`, mode 0755,
    as pip installs it; returns its path."""
    module, _, func = console_scripts(pyproject)[name].partition(":")
    text = shebang(python) + LAUNCHER_TEMPLATE.format(
        module=module.strip(), import_name=func.strip().split(".")[0], func=func.strip())
    path = Path(bin_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    os.chmod(path, 0o755)
    return path


def bridge_bytes(path: PathLike) -> bytes:
    """A `.vdb` file's bytes without its header's random UUID, so two
    writes of the same grids compare equal."""
    data = Path(path).read_bytes()
    uuid = data[VDB_UUID].decode("ascii")
    if [len(p) for p in uuid.split("-")] != [8, 4, 4, 4, 12]:
        raise ValueError(f"{path}: no UUID at bytes 21-56 of the header")
    return data[:VDB_UUID.start] + data[VDB_UUID.stop:]
