"""The port's `vqvdb-torch` executable as the Houdini HDK SOPs run it
(`hdk/SOP_VQVDB.cpp`), on the CPU.

`pyproject.toml`'s `vqvdb-torch` entry is turned into the launcher pip
installs (`integrations/hdk.py::write_launcher`) and driven by the SOPs'
own command lines (`encode_line` / `decode_line`, each with ` --device
cpu` appended: the SOP sends no `--device`, and the card is the default)
through `/bin/sh -c "<line> 2>&1"`, as `popen` runs them. The bridge is a
blosc-compressed, half-float `.vdb` (what Houdini writes) of 256 seeded
leaves in a directory whose name holds a space and a `'`. Held here:

- the entry names `vqvdb_tpu_torch.cli:main` and loads with `jax` and the
  JAX package blocked; the launcher is pip's, byte for byte;
- the quoting gets a space, `'`, `$`, a backtick and `;` through the shell
  unchanged, and the CLI's parser sees exactly the intended argv;
- every cook exits 0 and writes the bytes the same argv writes through
  in-process `main` (residual Off, Int8, Half; encode and decode, the
  `.vdb` but for its UUID);
- batch sizes 1, 7 and 257 give equal indices and decoded `.vdb` files
  byte-identical but for the header's random UUID (`hdk.bridge_bytes`);
- the launcher of the JAX `vqvdb` entry on the same line with
  `--compute-dtype float32` writes the same file except in the index bytes
  of near-tie rows and decodes within 1e-5 (test_torch_port_cli.py's
  tolerance);
- the two error cooks (an input that does not exist, no `--model`) exit
  as the JAX launcher does, with the cause in the combined output.

Children run with OMP_NUM_THREADS=2 and this process with two threads, so
both sum in the same order; they run four at a time.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vqvdb_tpu_torch.cli import build_parser
from vqvdb_tpu_torch.cli import main as cli
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.integrations import hdk
from vqvdb_tpu_torch.tools.roundtrip import field
from vqvdb_tpu_torch.vdb.openvdb_io import COMPRESS_BLOSC, read_vdb_leafgrids, write_vdb_leafgrids

THREADS = 2
torch.set_num_threads(THREADS)

REPO = Path(__file__).resolve().parent.parent
MODEL = REPO / "models" / "scalar.vqmodel"
CPU = " --device cpu"
F32 = " --compute-dtype float32"
LEAVES = 256
BATCHES = (1, 7, LEAVES + 1)
RESIDUALS = {0: "off", 1: "int8", 2: "half"}
MISSING_INPUT = "No such file or directory"
MISSING_MODEL = "the following arguments are required: --model"


def _env(jax_side=False):
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS), VQVDB_COMPILE_CACHE="off",
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO),
                                                        os.environ.get("PYTHONPATH")])))
    if jax_side:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _cook(line, jax_side=False):
    return hdk.run_line(line, env=_env(jax_side), timeout=600)


def _indices(path):
    with VqvdbReader(path) as r:
        return r.read_grid()[1]


@pytest.fixture(scope="module")
def sop(tmp_path_factory):
    """Every child cook of the file, run four at a time: {key: (status,
    combined output)}, the files they wrote, and the launchers."""
    root = tmp_path_factory.mktemp("hdk") / "SOP cooks 'hip' dir"
    root.mkdir()
    bridge = root / "bridge in.vdb"
    write_vdb_leafgrids(bridge, [field(11, LEAVES)], compression=COMPRESS_BLOSC, half=True)
    ours = hdk.write_launcher("vqvdb-torch", root / "bin")
    theirs = hdk.write_launcher("vqvdb", root / "bin")
    f = {k: root / f"{k}.vqvdb" for k in
         [*RESIDUALS.values(), *(f"b{b}" for b in BATCHES), "f32", "jax_f32"]}
    jobs = {}
    for r, name in RESIDUALS.items():
        jobs[name] = [hdk.encode_line(ours, bridge, f[name], model=MODEL, residual=r) + CPU,
                      hdk.decode_line(ours, f[name], root / f"{name}.vdb", model=MODEL) + CPU]
    for b in BATCHES:
        name = f"b{b}"
        jobs[name] = [hdk.encode_line(ours, bridge, f[name], b, model=MODEL) + CPU,
                      hdk.decode_line(ours, f[name], root / f"{name}.vdb", b, model=MODEL) + CPU]
    # the port's f32 file is decoded by both launchers on the same line
    jobs["f32"] = [hdk.encode_line(ours, bridge, f["f32"], 64, model=MODEL) + F32 + CPU,
                   hdk.decode_line(ours, f["f32"], root / "f32.vdb", 64, model=MODEL) + F32 + CPU,
                   hdk.decode_line(theirs, f["f32"], root / "jax_f32.vdb", 64, model=MODEL) + F32]
    jobs["jax_f32"] = [hdk.encode_line(theirs, bridge, f["jax_f32"], 64, model=MODEL) + F32]
    missing = root / "no such 'file'.vdb"
    for side, cmd, extra in (("ours", ours, CPU), ("jax", theirs, "")):
        jobs[f"{side}_missing_input"] = [
            hdk.encode_line(cmd, missing, root / "x.vqvdb", model=MODEL) + extra]
        jobs[f"{side}_missing_model"] = [hdk.encode_line(cmd, bridge, root / "y.vqvdb") + extra]

    def run(lines):
        return [_cook(line, jax_side=line.startswith(hdk.quoted(theirs))) for line in lines]

    # the JAX children take longest (about 20 s of model loading each): first
    order = sorted(jobs, key=lambda k: ("jax" not in k and k != "f32", k))
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {k: pool.submit(run, jobs[k]) for k in order}
        twins = {name: _twins(jobs[name], ours, root / "twin" / name)
                 for name in RESIDUALS.values()}  # meanwhile, in this process
        results = {k: fut.result() for k, fut in futures.items()}
    return {"root": root, "bridge": bridge, "ours": ours, "theirs": theirs, "files": f,
            "jobs": jobs, "results": results, "twins": twins}


def _twins(lines, ours, out_dir):
    """In-process main on the argv of a SOP encode line and decode line of
    `ours`, each writing into `out_dir` (the decode reads the twin's own
    encoded file): (encode status, its file, decode status, its .vdb)."""
    import shlex

    out_dir.mkdir(parents=True)
    enc, dec = (shlex.split(line) for line in lines)
    assert enc[0] == dec[0] == str(ours)
    encoded, decoded = out_dir / "twin.vqvdb", out_dir / "twin.vdb"
    enc[3], dec[2], dec[3] = str(encoded), str(encoded), str(decoded)
    return cli(enc[1:]), encoded, cli(dec[1:]), decoded


def test_entry_names_the_port_cli_and_loads_without_jax(tmp_path):
    scripts = hdk.console_scripts()
    assert scripts["vqvdb-torch"] == "vqvdb_tpu_torch.cli:main"
    assert scripts["vqvdb"] == "vqvdb_tpu.cli:main"
    script = r"""
import importlib.metadata, runpy, sys
for name in ("jax", "jaxlib", "flax", "vqvdb_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
main = importlib.metadata.EntryPoint("vqvdb-torch", sys.argv[2], "console_scripts").load()
launcher = runpy.run_path(sys.argv[1], run_name="launcher")
assert launcher["main"] is main, "the launcher imports another main"
try:
    main(["encode", "--help"])
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(m for m in sys.modules if (m == "jax" or m.startswith(("jax.", "vqvdb_tpu.")))
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""
    launcher = hdk.write_launcher("vqvdb-torch", tmp_path)
    out = subprocess.run([sys.executable, "-c", script, str(launcher),
                          scripts["vqvdb-torch"]], capture_output=True, text=True,
                         env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "LEAKED []"


@pytest.mark.parametrize("python", [sys.executable, "/home/artist/a venv/bin/python3",
                                    "/home/" + "deep/" * 30 + "python3"])
def test_launcher_is_what_pip_writes(tmp_path, monkeypatch, python):
    """pip's own script maker, set up as pip's wheel installer sets it up,
    on this interpreter and on paths that need its /bin/sh trampoline."""
    wheel = pytest.importorskip("pip._internal.operations.install.wheel")
    from pip._vendor.distlib import scripts

    monkeypatch.setattr(scripts, "get_executable", lambda: python)
    maker = wheel.PipScriptMaker(None, str(tmp_path / "pip"))
    maker.clobber, maker.variants, maker.set_mode = True, {""}, True
    for name, value in hdk.console_scripts().items():
        (want,) = maker.make(f"{name} = {value}")
        got = hdk.write_launcher(name, tmp_path / "ours", python=python)
        assert got.read_bytes() == Path(want).read_bytes()
        assert os.access(got, os.X_OK)


ARGV_SCRIPT = "import json, sys\nprint(json.dumps(sys.argv[1:]))\n"


@pytest.mark.parametrize("value", ["two words", "it's", "$HOME", "`touch pwned`",
                                   "a; touch pwned", "all of 'it' $HOME `id`; x"])
def test_quoting_reaches_the_parser_verbatim(tmp_path, value):
    script = tmp_path / value / "vqvdb argv"
    script.parent.mkdir(parents=True)
    script.write_text(hdk.shebang(sys.executable) + ARGV_SCRIPT)
    script.chmod(0o755)
    for side in ("encode", "decode"):
        if side == "encode":
            line = hdk.encode_line(script, value, value + ".vqvdb", 7, grid=value,
                                   model=value, residual=2)
            tail = ["--grid", value, "--model", value, "--residual", "f16"]
        else:
            line = hdk.decode_line(script, value, value + ".vdb", 7, grid=value,
                                   model=value)
            tail = ["--grid", value, "--model", value]
        status, out = hdk.run_line(line, env=_env(), timeout=120)
        assert status == 0, out
        argv = json.loads(out.strip().splitlines()[-1])
        out_path = value + (".vqvdb" if side == "encode" else ".vdb")
        assert argv == [side, value, out_path, "--batch-size", "7", *tail]
        args = build_parser().parse_args(argv)  # the parser main runs
        assert (args.input, args.output, args.model) == (value, out_path, value)
        assert args.grid == (value if side == "encode" else [value])
    assert not (Path.cwd() / "pwned").exists() and not (tmp_path / "pwned").exists()


@pytest.mark.parametrize("residual", list(RESIDUALS.values()))
def test_cooks_write_what_in_process_main_writes(sop, residual):
    ((erc, eout), (drc, dout)) = sop["results"][residual]
    assert erc == 0, eout
    assert drc == 0, dout
    encoded, decoded = sop["files"][residual], sop["root"] / f"{residual}.vdb"
    twin_erc, twin_file, twin_drc, twin_vdb = sop["twins"][residual]
    assert twin_erc == twin_drc == 0
    assert twin_file.read_bytes() == encoded.read_bytes()
    with VqvdbReader(encoded) as r:
        meta = r.next_grid_metadata()
    assert (r.version, meta.residual_mode) == ({"off": 3}.get(residual, 6),
                                               {"off": 0, "int8": 1, "half": 2}[residual])
    assert hdk.bridge_bytes(twin_vdb) == hdk.bridge_bytes(decoded)
    (grid,) = read_vdb_leafgrids(decoded)
    assert grid.num_leaves == LEAVES and np.isfinite(grid.leaves).all()


def test_batch_sizes_agree(sop):
    for b in BATCHES:
        for status, out in sop["results"][f"b{b}"]:
            assert status == 0, out
    files, root = sop["files"], sop["root"]
    want = _indices(files["off"])
    vdb = hdk.bridge_bytes(root / "off.vdb")
    for b in BATCHES:
        np.testing.assert_array_equal(_indices(files[f"b{b}"]), want)
        assert hdk.bridge_bytes(root / f"b{b}.vdb") == vdb, f"batch {b}"


def test_matches_the_jax_launcher_on_the_same_line(sop):
    """Files equal off the index bytes of near-tie rows; decoded leaves
    within 1e-5 (`--compute-dtype float32` on both)."""
    for key in ("f32", "jax_f32"):
        for status, out in sop["results"][key]:
            assert status == 0, out
    ours, theirs = sop["files"]["f32"], sop["files"]["jax_f32"]
    bad = (_indices(ours) != _indices(theirs)).reshape(-1)
    if bad.any():
        from test_torch_port_cli import _near_tie_rows
        from vqvdb_tpu.core import artifact as jartifact

        (grid,) = read_vdb_leafgrids(sop["bridge"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jartifact, "init_vqvae_params",
                       jax.jit(jartifact.init_vqvae_params, static_argnums=1))
            assert not (bad & ~_near_tie_rows(grid.leaves)).any()
    a, b = (np.frombuffer(p.read_bytes(), np.uint8) for p in (ours, theirs))
    assert a.shape == b.shape and (a != b).sum() == bad.sum()
    (got,), (want,) = (read_vdb_leafgrids(sop["root"] / f"{k}.vdb") for k in ("f32", "jax_f32"))
    np.testing.assert_array_equal(got.origins, want.origins)
    np.testing.assert_allclose(got.leaves, want.leaves, atol=1e-5)


@pytest.mark.parametrize("case,cause", [("missing_input", MISSING_INPUT),
                                        ("missing_model", MISSING_MODEL)])
def test_error_cooks_exit_as_the_jax_launcher(sop, case, cause):
    ((status, out),), ((jstatus, jout),) = (sop["results"][f"{s}_{case}"]
                                            for s in ("ours", "jax"))
    assert status == jstatus and status in (1, 2)
    assert cause in out and cause in jout
    assert "Traceback" not in out
