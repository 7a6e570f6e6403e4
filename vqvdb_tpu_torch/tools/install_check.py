"""Install the repo offline, as on a machine with no network and no JAX,
and cook once through the installed `vqvdb-torch`.

    python -m vqvdb_tpu_torch.tools.install_check [--venv DIR] [--leaves 4096]
        [--device cuda|cpu]

Makes a virtual environment that sees the system's packages (`python3 -m
venv --system-site-packages DIR`; a temporary directory by default) and,
when the Python running this lives in a venv itself, that venv's site
directories too (a `.pth` file: `--system-site-packages` reaches only the
base interpreter's, and torch and numpy may not be there), installs the repo into it with `pip install --no-deps --no-build-isolation
-e <repo>` (editable, because `runtime/native_io.py` builds its library
from `native/` at the repo root, which a wheel would not carry; with
`--no-index --disable-pip-version-check`, so pip asks no server), then runs
the encoder SOP's line and the decoder SOP's line (`integrations/hdk.py`)
through `DIR/bin/vqvdb-torch` on a blosc, half-float bridge `.vdb` of a
seeded field, with the flagship model. `--device cpu` appends `--device
cpu` to both lines; the SOP itself sends none, so the card is the default.

Prints one JSON line: the site directories added, the environment's
Python, pip and setuptools versions, where its `vqvdb_tpu_torch` comes
from, the install's exit status
and seconds (and the end of its output when it failed), and each cook's
exit status, seconds and printed JSON. Exits 1 when a step failed. The
install writes `vqvdb_tpu.egg-info/` into the repo (ignored by git).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
VERSIONS = ("import importlib.metadata as m, json, sys, vqvdb_tpu_torch; "
            "print(json.dumps({'python': sys.version.split()[0], 'pip': m.version('pip'), "
            "'setuptools': m.version('setuptools'), "
            "'vqvdb_tpu_torch': vqvdb_tpu_torch.__file__}))")


def _run(argv, timeout=900):
    t0 = time.perf_counter()
    proc = subprocess.run(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def _last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def _see_this_environment(python: Path) -> list:
    """Make the venv of `python` see this interpreter's site directories
    (a `.pth` file of the ones it lacks), and return them. A venv made with
    --system-site-packages sees its base interpreter's packages; when this
    interpreter lives in a venv itself, torch, numpy and setuptools may be
    that venv's and not the base's."""
    import site

    ours = [d for d in [*site.getsitepackages(),
                        site.getusersitepackages() if site.ENABLE_USER_SITE else ""]
            if d and Path(d).is_dir()]
    rc, text, _ = _run([str(python), "-c",
                        "import json, sys; print(json.dumps(sys.path))"])
    if rc != 0:
        raise RuntimeError(f"{python} does not start:\n{text}")
    theirs = set(json.loads(text.strip().splitlines()[-1]))
    missing = [d for d in ours if d not in theirs]
    if missing:
        rc, text, _ = _run([str(python), "-c",
                            "import site; print(site.getsitepackages()[0])"])
        (Path(text.strip().splitlines()[-1]) / "vqvdb_outer_site.pth").write_text(
            "".join(f"{d}\n" for d in missing))
    return missing


def check(venv: Path, leaves: int, device: str) -> dict:
    from vqvdb_tpu_torch.integrations import hdk
    from vqvdb_tpu_torch.tools.roundtrip import field
    from vqvdb_tpu_torch.vdb.openvdb_io import COMPRESS_BLOSC, write_vdb_leafgrids

    out = {}
    rc, text, secs = _run([sys.executable, "-m", "venv", "--system-site-packages", str(venv)])
    out["venv"] = {"exit": rc, "s": secs}
    if rc != 0:
        out["venv"]["output"] = text[-3000:]
        return out
    python = venv / "bin" / "python"
    out["sees_this_environment"] = _see_this_environment(python)
    rc, text, secs = _run([str(python), "-m", "pip", "install", "--no-deps",
                           "--no-build-isolation", "--no-index",
                           "--disable-pip-version-check", "-e", str(REPO)])
    out["install"] = {"exit": rc, "s": secs}
    if rc != 0:
        out["install"]["output"] = text[-3000:]
        return out
    rc, text, _ = _run([str(python), "-c", VERSIONS])
    out["versions"] = _last_json(text) if rc == 0 else text[-3000:]
    cmd = venv / "bin" / "vqvdb-torch"
    work = venv / "cook dir"
    work.mkdir()
    bridge = work / "bridge.vdb"
    write_vdb_leafgrids(bridge, [field(0, leaves)], compression=COMPRESS_BLOSC, half=True)
    model = REPO / "models" / "scalar.vqmodel"
    extra = "" if device == "cuda" else f" --device {device}"
    for label, line in (
            ("encode", hdk.encode_line(cmd, bridge, work / "out.vqvdb", model=model)),
            ("decode", hdk.decode_line(cmd, work / "out.vqvdb", work / "out.vdb",
                                       model=model))):
        t0 = time.perf_counter()
        status, text = hdk.run_line(line + extra, timeout=900)
        out[label] = {"exit": status, "s": time.perf_counter() - t0,
                      "json": _last_json(text)}
        if status != 0:
            out[label]["output"] = text[-3000:]
            break
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--venv", type=Path, default=None,
                    help="where to make the environment (default: a temporary directory)")
    ap.add_argument("--leaves", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    tmp = None
    if args.venv is None:
        tmp = tempfile.mkdtemp(prefix="vqvdb_venv_")
        args.venv = Path(tmp) / "venv"
    try:
        res = check(args.venv, args.leaves, args.device)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(res))
    ok = all(res.get(k, {}).get("exit") == 0 for k in ("venv", "install", "encode", "decode"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
