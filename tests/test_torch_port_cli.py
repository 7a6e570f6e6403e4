"""The port's API and CLI (`vqvdb_tpu_torch.api`, `python -m
vqvdb_tpu_torch.cli`) against the JAX package's, on the CPU.

Both CLIs run in-process on the same inputs with `--compute-dtype float32`
(the port's with `--device cpu`). Files written by the two must be equal
except in the index bytes of near-tie rows (best and runner-up JAX scores
within 1e-5 relative: the flagship holds near-duplicate codes); `info`,
`verify`, `transcode` and `vdbinfo` must print the same JSON; usage errors
exit 2 in both; `serve`, `import-torch`, `export-checkpoint`, `export-torch`
and `export-onnx` answer, write and exit as the JAX CLI's (train, datagen
and eval: test_torch_port_eval.py); --data-parallel on `--device cpu`
writes what the run without it writes, and exits 2 on a device with an
index. The port's encode / decode JSON has the JAX keys and `host_seconds`.
"""

import json
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.cli import main as jax_cli
from vqvdb_tpu.core.artifact import load_model as jax_load_model
from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.models.vqvae import encoder_features as jax_encoder_features
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.train.synthetic import smoke_grid
from vqvdb_tpu.vdb.openvdb_io import COMPRESS_ACTIVE_MASK, COMPRESS_BLOSC
from vqvdb_tpu_torch import api
from vqvdb_tpu_torch.cli import main as cli
from vqvdb_tpu_torch.format.vqvdb import GridMetadata, VqvdbReader, VqvdbWriter
from vqvdb_tpu_torch.vdb.grid import LeafGrid, psnr
from vqvdb_tpu_torch.vdb.openvdb_io import read_vdb_leafgrids, write_vdb_leafgrids

torch.set_num_threads(2)

MODEL = Path(__file__).parent.parent / "models" / "scalar.vqmodel"
REF_MODEL = MODEL.parent / "scalar_reference.vqmodel"
NEAR_TIE = 1e-5
CPU = ["--device", "cpu"]
F32 = ["--batch-size", "64", "--compute-dtype", "float32"]


def _run(main, argv, capsys):
    """(exit code, the last JSON object printed)."""
    rc = main([str(a) for a in argv])
    out = capsys.readouterr().out.strip()
    if not out:
        return rc, None
    try:
        return rc, json.loads(out)
    except json.JSONDecodeError:
        return rc, json.loads(out.splitlines()[-1])


def _grid(seed=2024, size=48):
    g = smoke_grid(size, seed=seed)
    return LeafGrid("density", g.origins, g.leaves)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A smoke grid as .vdb, and each CLI's .vqvdb of it."""
    tmp = tmp_path_factory.mktemp("scene")
    vdb = tmp / "scene.vdb"
    write_vdb_leafgrids(vdb, [_grid()])
    return tmp, vdb


def _near_tie_rows(leaves):
    jparams, jcfg = jax_load_model(MODEL)
    jcodec = JaxCodec(jparams, jcfg, JaxCodecConfig(batch_size=64, compute_dtype="float32"))
    h = np.asarray(jax_encoder_features(jparams.encoder, jnp.asarray(leaves), jcfg))
    m, c = jcodec._score_mc
    s = h.reshape(-1, 64) @ np.asarray(m) + np.asarray(c)
    two = np.sort(s, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))


def _indices(path):
    with VqvdbReader(path) as r:
        return r.read_grid()[1]


def test_vdb_encode_decode_match_jax_cli(scene, capsys):
    """encode .vdb -> .vqvdb and decode -> .vdb through both CLIs: files
    equal off near-tie rows, the same JSON keys (plus host_seconds), the
    decoded .vdb above 30 dB and equal to the port's decompress."""
    tmp, vdb = scene
    ours, theirs = tmp / "ours.vqvdb", tmp / "theirs.vqvdb"
    rc, enc = _run(cli, ["encode", vdb, ours, "--model", MODEL, *CPU, *F32], capsys)
    jrc, jenc = _run(jax_cli, ["encode", vdb, theirs, "--model", MODEL, *F32], capsys)
    assert rc == jrc == 0
    assert set(enc) == set(jenc) | {"host_seconds"}
    assert enc["leaves"] == jenc["leaves"] and enc["grids"] == jenc["grids"] == 1
    (grid,) = read_vdb_leafgrids(vdb)
    bad = (_indices(ours) != _indices(theirs)).reshape(-1)
    assert not (bad & ~_near_tie_rows(grid.leaves)).any()
    a, b = (np.frombuffer(p.read_bytes(), np.uint8) for p in (ours, theirs))
    assert a.shape == b.shape and (a != b).sum() == bad.sum()
    # the streamed encode writes the same bytes
    streamed = tmp / "streamed.vqvdb"
    rc, _ = _run(cli, ["encode", vdb, streamed, "--streaming", "--model", MODEL, *CPU, *F32],
                 capsys)
    assert rc == 0 and streamed.read_bytes() == ours.read_bytes()
    out_vdb, jout_vdb = tmp / "recon.vdb", tmp / "jrecon.vdb"
    rc, dec = _run(cli, ["decode", theirs, out_vdb, "--model", MODEL, *CPU, *F32], capsys)
    jrc, jdec = _run(jax_cli, ["decode", theirs, jout_vdb, "--model", MODEL, *F32], capsys)
    assert rc == jrc == 0 and dec["vdb"] == str(out_vdb)
    assert set(dec) == set(jdec) | {"host_seconds"}
    (recon,), (jrecon,) = read_vdb_leafgrids(out_vdb), read_vdb_leafgrids(jout_vdb)
    np.testing.assert_array_equal(recon.origins, jrecon.origins)
    np.testing.assert_allclose(recon.leaves, jrecon.leaves, atol=1e-5)
    grids, _ = api.decode(theirs, MODEL, batch_size=64, device="cpu")
    order = np.lexsort(grids[0].origins.T[::-1])
    rorder = np.lexsort(recon.origins.T[::-1])
    np.testing.assert_array_equal(recon.origins[rorder], grids[0].origins[order])
    assert psnr(recon.leaves[rorder], grid.leaves[np.lexsort(grid.origins.T[::-1])]) > 30.0


def test_npy_inputs_and_outputs(tmp_path, capsys):
    """npy leaf files with sidecars, dense npy volumes and directories in;
    --grid, --bbox, --dense and npy leaf directories out, as the JAX CLI."""
    g = _grid(seed=7, size=32)
    src = tmp_path / "in"
    src.mkdir()
    g.save_npy(src / "density.npy")
    dense, _ = g.to_dense()
    np.save(src / "vol.npy", dense[..., 0])
    for name, main, extra in (("ours", cli, CPU), ("theirs", jax_cli, [])):
        rc, enc = _run(main, ["encode", src, tmp_path / f"{name}.vqvdb", "--model", MODEL,
                              *extra, *F32], capsys)
        assert rc == 0 and enc["grids"] == 2
    assert [len(_indices_of(tmp_path / f"{n}.vqvdb")) for n in ("ours", "theirs")] == [2, 2]
    # Both decode the JAX CLI's file, so the leaves differ by sums alone.
    path = tmp_path / "theirs.vqvdb"
    for name, main, extra in (("ours", cli, CPU), ("theirs", jax_cli, [])):
        rc, dec = _run(main, ["decode", path, tmp_path / f"{name}_out", "--model", MODEL,
                              "--grid", "vol", "--bbox", "0,0,0,16,32,32", *extra, *F32],
                       capsys)
        assert rc == 0 and dec["grids"] == ["vol"]
        rc, _ = _run(main, ["decode", path, tmp_path / f"{name}_dense", "--model", MODEL,
                            "--dense", *extra, *F32], capsys)
        assert rc == 0
    a = LeafGrid.load_npy(tmp_path / "ours_out" / "vol.npy")
    b = LeafGrid.load_npy(tmp_path / "theirs_out" / "vol.npy")
    np.testing.assert_array_equal(a.origins, b.origins)
    np.testing.assert_allclose(a.leaves, b.leaves, atol=1e-5)
    assert 0 < a.num_leaves < g.num_leaves and a.name == "vol"
    for f in ("density.dense.npy", "vol.dense.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "ours_dense" / f),
                                   np.load(tmp_path / "theirs_dense" / f), atol=1e-5)
    for f in ("density.origin.json", "vol.origin.json"):
        assert ((tmp_path / "ours_dense" / f).read_text()
                == (tmp_path / "theirs_dense" / f).read_text())


def _indices_of(path):
    """{grid name: indices} of a .vqvdb file."""
    out = {}
    with VqvdbReader(path) as r:
        for meta, batches in r.iter_grids():
            out[meta.name] = np.concatenate([i for i, _ in batches])
    return out


def _assert_close_json(a, b, rel=1e-4):
    """Equal structure and values, floats within `rel` (the two packages'
    decodes differ by their f32 sums)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_close_json(a[k], b[k], rel)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close_json(x, y, rel)
    elif isinstance(a, float) and not isinstance(a, bool):
        assert a == pytest.approx(b, rel=rel)
    else:
        assert a == b


def test_info_verify_transcode_vdbinfo_print_the_jax_json(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=7))
    g = _grid(seed=3, size=32)
    vq = tmp_path / "r.vqvdb"
    src = tmp_path / "g.npy"
    g.save_npy(src)
    rc, _ = _run(cli, ["encode", src, vq, "--model", MODEL, "--residual", "int8",
                       "--v5-codec", "lz4", *CPU, *F32], capsys)
    vq3 = tmp_path / "v3.vqvdb"
    rc3, _ = _run(cli, ["encode", src, vq3, "--model", MODEL, *CPU, *F32], capsys)
    assert rc == rc3 == 0
    for cmd in (["info", vq], ["verify", vq], ["verify", tmp_path]):
        rc, ours = _run(cli, cmd, capsys)
        jrc, theirs = _run(jax_cli, cmd, capsys)
        assert rc == jrc == 0 and ours == theirs, cmd
    # Round-trip reports decode the file again: values within the packages'
    # f32 differences. v6 residuals are measured against the writer's own
    # decode, so the bound is the port's to hold on its file.
    cmd = ["verify", vq3, "--against", src, "--model", MODEL, *F32]
    rc, ours = _run(cli, cmd + CPU, capsys)
    jrc, theirs = _run(jax_cli, cmd, capsys)
    assert rc == jrc == 0
    _assert_close_json(ours, theirs)
    rc, ours = _run(cli, ["verify", vq, "--against", src, "--model", MODEL, *F32, *CPU], capsys)
    assert rc == 0 and ours["ok"] and ours["grids"][0]["bound_ok"]
    for i, extra in enumerate((["--format-version", "5"],
                               ["--format-version", "5", "--drop-residual"])):
        rc, ours = _run(cli, ["transcode", vq, tmp_path / f"a{i}.vqvdb", *extra], capsys)
        jrc, theirs = _run(jax_cli, ["transcode", vq, tmp_path / f"b{i}.vqvdb", *extra], capsys)
        assert rc == jrc
        if rc == 0:
            ours.pop("output", None), theirs.pop("output", None)
            assert ours == theirs
            assert ((tmp_path / f"a{i}.vqvdb").read_bytes()
                    == (tmp_path / f"b{i}.vqvdb").read_bytes())
    vdb = tmp_path / "h.vdb"
    write_vdb_leafgrids(vdb, [g], compression=COMPRESS_BLOSC | COMPRESS_ACTIVE_MASK, half=True)
    rc, ours = _run(cli, ["vdbinfo", vdb], capsys)
    jrc, theirs = _run(jax_cli, ["vdbinfo", vdb], capsys)
    assert rc == jrc == 0 and ours == theirs and ours["grids"][0]["half_float"]


def test_info_reports_v4_and_v5(tmp_path, capsys):
    path = tmp_path / "big.vqvdb"
    idx = np.arange(2 * 64, dtype=np.uint16).reshape(2, 4, 4, 4) % 4096
    with VqvdbWriter(path, version=4) as w:
        w.start_grid(GridMetadata("v", num_embeddings=4096, latent_shape=(4, 4, 4),
                                  total_blocks=2))
        w.write_batch(idx, np.zeros((2, 3), np.int32))
        w.end_grid()
    rc, info = _run(cli, ["info", path], capsys)
    assert rc == 0 and info["version"] == 4 and info["num_embeddings"] == 4096
    assert info["grids"][0]["chunk_bytes"] == 12 + 64 * 2
    assert info["grids"][0]["payload_bytes"] == 2 * (12 + 64 * 2)
    assert "payload_codec" not in info["grids"][0]
    n = 64
    origins = np.zeros((n, 3), np.int32)
    origins[:, 0] = np.arange(n) * 8
    with VqvdbWriter(path, version=5, compression="zlib") as w:
        w.start_grid(GridMetadata("g", num_embeddings=256, latent_shape=(4, 4, 4),
                                  total_blocks=n))
        w.write_batch(np.zeros((n, 4, 4, 4), np.uint8), origins)
        w.end_grid()
    rc, info = _run(cli, ["info", path], capsys)
    g = info["grids"][0]
    assert rc == 0 and g["payload_codec"] == "zlib" and g["frame_compression"] > 1.0
    assert 0 < g["payload_bytes"] < n * (12 + 64)


@pytest.mark.parametrize("argv", [
    ["encode", "{tmp}/missing_dir", "{tmp}/o.vqvdb", "--model", MODEL, "--grid", "nope"],
    ["encode", "{tmp}/g.npy", "{tmp}/o.vqvdb", "--model", MODEL, "--streaming"],
    ["encode", "{tmp}/g.npy", "{tmp}/o.vqvdb", "--model", MODEL, "--grid", "nope"],
    ["decode", "{tmp}/r.vqvdb", "{tmp}/out", "--model", MODEL, "--bbox", "1,2,3"],
    ["verify", "{tmp}/r.vqvdb", "--against", "{tmp}/g.npy"],
    ["verify", "{tmp}", "--against", "{tmp}/g.npy"],
    ["encode-seq", "{tmp}/empty", "{tmp}/seq", "--model", MODEL],
    ["extract", "{tmp}/empty", "{tmp}/x"],
])
def test_usage_errors_exit_as_jax(tmp_path, capsys, argv):
    g = _grid(seed=5, size=16)
    g.save_npy(tmp_path / "g.npy")
    (tmp_path / "empty").mkdir()
    api.encode(g, MODEL, tmp_path / "r.vqvdb", batch_size=64, device="cpu")
    argv = [str(a).format(tmp=tmp_path) for a in argv]
    needs_model = any(a in ("encode", "decode", "encode-seq") for a in argv[:1])
    rc, _ = _run(cli, argv + (CPU if needs_model else []), capsys)
    jrc, _ = _run(jax_cli, argv, capsys)
    assert rc == jrc and rc in (1, 2)


@pytest.fixture
def fast_jax_load(monkeypatch):
    """The JAX loader draws a template tree for the params' structure; the
    jitted initialiser draws it in one program instead of op by op."""
    from vqvdb_tpu.core import artifact as jartifact

    monkeypatch.setattr(jartifact, "init_vqvae_params",
                        jax.jit(jartifact.init_vqvae_params, static_argnums=1))


def _ref_scores(leaves):
    """JAX nearest-code scores [N*64, K] of the reference arch's latents."""
    from vqvdb_tpu.models.vqvae import encoder_apply

    jparams, jcfg = jax_load_model(REF_MODEL)
    z = np.asarray(encoder_apply(jparams.encoder, jnp.asarray(leaves), jcfg)).reshape(-1, 128)
    e = np.asarray(jparams.vq.embedding)
    return (e * e).sum(1)[None] - 2.0 * z @ e.T


def test_serve_answers_as_the_jax_cli_serve(monkeypatch, capsys, fast_jax_load):
    """`serve --port 0` of both CLIs, each in a thread and torn down by the
    test: the same /healthz, /encode_leaves indices off near-ties, and both
    return 0 once their server shuts down."""
    import http.client
    import io
    import threading
    import time

    from vqvdb_tpu import serving as jserving
    from vqvdb_tpu_torch import serving

    servers = {}
    for key, module in (("ours", serving), ("theirs", jserving)):
        def make(service, host, port, real=module.make_server, key=key):
            srv = real(service, host, port)
            servers[key] = srv
            return srv

        monkeypatch.setattr(module, "make_server", make)
    argv = ["serve", "--model", str(REF_MODEL), "--port", "0", *F32]
    rcs = {}
    threads = [threading.Thread(target=lambda: rcs.__setitem__("ours", cli(argv + CPU))),
               threading.Thread(target=lambda: rcs.__setitem__("theirs", jax_cli(argv)))]
    for t in threads:
        t.start()
    deadline = time.time() + 240
    while len(servers) < 2 and time.time() < deadline and all(t.is_alive() for t in threads):
        time.sleep(0.05)
    assert len(servers) == 2, "a server did not start"

    def request(key, method, path, body=None):
        conn = http.client.HTTPConnection(*servers[key].server_address, timeout=120)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    try:
        (s1, a), (s2, b) = request("ours", "GET", "/healthz"), request("theirs", "GET", "/healthz")
        assert s1 == s2 == 200 and json.loads(a) == json.loads(b)
        leaves = np.random.default_rng(3).random((5, 8, 8, 8, 1), np.float32)
        buf = io.BytesIO()
        np.save(buf, leaves)
        (s1, a), (s2, b) = (request("ours", "POST", "/encode_leaves", buf.getvalue()),
                            request("theirs", "POST", "/encode_leaves", buf.getvalue()))
        assert s1 == s2 == 200
        got, want = np.load(io.BytesIO(a)), np.load(io.BytesIO(b))
        assert got.shape == want.shape == (5, 4, 4, 4) and got.dtype == want.dtype
        bad = (got != want).reshape(-1)
        two = np.sort(_ref_scores(leaves), axis=1)[:, :2]
        assert not (bad & ~((two[:, 1] - two[:, 0]) < NEAR_TIE * np.abs(two[:, 0]))).any()
    finally:
        for srv in servers.values():
            srv.shutdown()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads) and rcs == {"ours": 0, "theirs": 0}
    out = capsys.readouterr().out
    assert out.count("[serve] listening on http://127.0.0.1:") == 2
    port = servers["ours"].server_address[1]
    assert f"127.0.0.1:{port} (model: " in out


def test_import_torch_writes_the_jax_clis_vqmodel(tmp_path, capsys, fast_jax_load):
    from vqvdb_tpu.interop.torch_export import save_reference_checkpoint

    jparams, jcfg = jax_load_model(REF_MODEL)
    pth = tmp_path / "ref.pth"
    save_reference_checkpoint(pth, jparams, jcfg)
    rc, ours = _run(cli, ["import-torch", pth, tmp_path / "a.vqmodel", *CPU], capsys)
    jrc, theirs = _run(jax_cli, ["import-torch", pth, tmp_path / "b.vqmodel"], capsys)
    assert rc == jrc == 0 and ours["imported"] == theirs["imported"] == str(pth)
    assert (tmp_path / "a.vqmodel").read_bytes() == (tmp_path / "b.vqmodel").read_bytes()


def test_export_checkpoint_exits_as_the_jax_cli(tmp_path, capsys):
    """Both CLIs exit 2 with the same message on a directory without
    checkpoints; the port exports its own checkpoint's params (the
    training-run case: tests/test_torch_port_interop.py)."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.train.checkpoint import CheckpointManager
    from vqvdb_tpu_torch.train.train import TrainConfig, make_train_state

    flags = ["--embedding-dim", "16", "--num-embeddings", "32"]
    for extra, msg in (([], "no checkpoints in"), (["--best"], "no best/ checkpoint in")):
        (tmp_path / "empty").mkdir(exist_ok=True)
        argv = [str(a) for a in ["export-checkpoint", tmp_path / "empty",
                                 tmp_path / "o.vqmodel", *flags, *extra]]
        rc = cli(argv + CPU)
        err = capsys.readouterr().err
        jrc = jax_cli(argv)
        assert rc == jrc == 2 and err == capsys.readouterr().err and msg in err
    cfg = ModelConfig(embedding_dim=16, num_embeddings=32)
    state = make_train_state(cfg, TrainConfig(seed=3), 1, device="cpu")
    CheckpointManager(tmp_path / "ck").save(7, state)
    rc, out = _run(cli, ["export-checkpoint", tmp_path / "ck", tmp_path / "p.vqmodel",
                         "--step", "7", *flags, *CPU], capsys)
    assert rc == 0 and out == {"checkpoint_step": 7, "best": False,
                               "model": str(tmp_path / "p.vqmodel")}
    save_model(tmp_path / "direct.vqmodel", state.params, cfg)
    assert (tmp_path / "p.vqmodel").read_bytes() == (tmp_path / "direct.vqmodel").read_bytes()


def test_export_torch_matches_the_jax_cli(tmp_path, capsys, fast_jax_load):
    out = {}
    for key, main, extra in (("ours", cli, CPU), ("theirs", jax_cli, [])):
        d = tmp_path / key
        rc, out[key] = _run(main, ["export-torch", REF_MODEL, "--checkpoint", d / "ref.pth",
                                   "--torchscript", d / "ref.pt", *extra], capsys)
        assert rc == 0
        rc, _ = _run(main, ["export-torch", REF_MODEL, *extra], capsys)
        assert rc == 2
    assert out["ours"].keys() == out["theirs"].keys() == {"checkpoint", "torchscript"}
    a = torch.load(tmp_path / "ours" / "ref.pth", weights_only=True)
    b = torch.load(tmp_path / "theirs" / "ref.pth", weights_only=True)
    assert a["epoch"] == b["epoch"] and list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    x = torch.from_numpy(np.random.default_rng(4).random((3, 1, 8, 8, 8), np.float32))
    ma, mb = (torch.jit.load(str(tmp_path / k / "ref.pt")) for k in ("ours", "theirs"))
    with torch.no_grad():
        ia, ib = ma.encode(x), mb.encode(x)
        assert torch.equal(ia, ib) and torch.equal(ma.decode(ia), mb.decode(ib))
    # The packed flagship has no reference module tree: both refuse it.
    for main, extra in ((cli, CPU), (jax_cli, [])):
        with pytest.raises(ValueError, match="reference module tree"):
            main(["export-torch", str(MODEL), "--checkpoint", str(tmp_path / "x.pth"), *extra])


def test_export_onnx_matches_the_jax_cli(tmp_path, capsys, fast_jax_load):
    """Byte-identical encoder.onnx, decoder.onnx and embed header; both
    validations pass the JAX rule (index agreement 1.0, decoder error under
    1e-5); a residual-VQ model exits 1 in both."""
    out = {}
    for key, main, extra in (("ours", cli, CPU), ("theirs", jax_cli, [])):
        d = tmp_path / key
        rc, out[key] = _run(main, ["export-onnx", REF_MODEL, d, "--embed-header",
                                   d / "bin_onnx.h", *extra], capsys)
        assert rc == 0, out[key]
    for name in ("encoder.onnx", "decoder.onnx", "bin_onnx.h"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes(), name
    ours, theirs = out["ours"], out["theirs"]
    assert ours.keys() == theirs.keys()
    assert ours["valid"] is theirs["valid"] is True
    assert ours["encoder_index_agreement"] == theirs["encoder_index_agreement"] == 1.0
    assert ours["decoder_max_abs_err"] < 1e-5
    rvq = MODEL.parent / "scalar_rvq2.vqmodel"
    for main, extra in ((cli, CPU), (jax_cli, [])):
        rc = main(["export-onnx", str(rvq), str(tmp_path / "rvq"), "--no-validate", *extra])
        assert rc == 1 and "residual-VQ" in capsys.readouterr().err


def test_data_parallel_exits_2(tmp_path, capsys):
    """--data-parallel takes every local device, so a device with an index
    is a usage error (exit 2) on every command that has the flag."""
    for argv in (["encode", "x.npy", str(tmp_path / "o.vqvdb"), "--model", str(MODEL)],
                 ["decode", "x.vqvdb", str(tmp_path / "o"), "--model", str(MODEL)],
                 ["train", "--data-dir", str(tmp_path)]):
        rc = cli(argv + ["--data-parallel", "--device", "cuda:1"])
        assert rc == 2 and "without an index" in capsys.readouterr().err


def test_data_parallel_on_the_cpu_writes_what_the_run_without_it_writes(tmp_path, capsys):
    """--data-parallel --device cpu (a mesh of the one CPU entry; `train` in
    this process): encode, decode, encode-seq / decode-seq and train write
    the bytes that the same commands write without it."""
    g = _grid(seed=5, size=32)
    g.save_npy(tmp_path / "density.npy")
    (tmp_path / "seq").mkdir()
    g.save_npy(tmp_path / "seq" / "f0.npy")
    (tmp_path / "data").mkdir()
    np.save(tmp_path / "data" / "leaves.npy", g.leaves[:40, ..., 0])
    for tag, dp in (("plain", []), ("dp", ["--data-parallel"])):
        out = tmp_path / tag
        out.mkdir()
        rc, _ = _run(cli, ["encode", tmp_path / "density.npy", out / "a.vqvdb", "--model",
                           MODEL, "--residual", "int8", *dp, *CPU, *F32], capsys)
        assert rc == 0
        rc, _ = _run(cli, ["decode", out / "a.vqvdb", out / "dec", "--model", MODEL, *dp,
                           *CPU, *F32], capsys)
        assert rc == 0
        rc, _ = _run(cli, ["encode-seq", tmp_path / "seq", out / "seq", "--glob", "f?.npy",
                           "--model", MODEL, *dp, *CPU, *F32], capsys)
        rc2, _ = _run(cli, ["decode-seq", out / "seq", out / "seqdec", "--model", MODEL,
                            *dp, *CPU, *F32], capsys)
        assert rc == rc2 == 0
        rc = cli(["train", "--data-dir", str(tmp_path / "data"), "--model-path",
                  str(out / "m.vqmodel"), "--epochs", "1", "--batch-size", "16",
                  "--embedding-dim", "16", "--num-embeddings", "32", "--encoder-arch",
                  "packed", "--compute-dtype", "float32", "--device-resident", *dp, *CPU])
        printed = capsys.readouterr().out
        assert rc == 0 and ("data-parallel device-resident over 1 devices" in printed) == bool(dp)
    for f in ("a.vqvdb", "dec/density.npy", "dec/density._origins.npy",
              "seq/frame_0000.vqvdb", "seqdec/frame_0000/density.npy", "m.vqmodel"):
        assert (tmp_path / "dp" / f).read_bytes() == (tmp_path / "plain" / f).read_bytes(), f


def test_sequences_api_and_cli(tmp_path, capsys):
    """encode_sequence / decode_sequence and encode-seq / decode-seq over
    per-frame .vdb assets, against the JAX CLI's frame files."""
    codec = api.make_codec(MODEL, batch_size=64, compute_dtype="float32", device="cpu")
    frames = [_grid(seed=10 + i, size=24) for i in range(2)]
    stats = api.encode_sequence(frames, codec, tmp_path / "seq", residual="int8",
                                compression="lz4")
    assert stats["frames"] == 2 and stats["leaves"] == sum(f.num_leaves for f in frames)
    decoded, dstats = api.decode_sequence(tmp_path / "seq", codec)
    assert dstats["frames"] == 2
    for frame, orig in zip(decoded, frames):
        np.testing.assert_array_equal(frame[0].origins, orig.origins)
        assert psnr(frame[0].leaves, orig.leaves) > 45.0
    in_dir = tmp_path / "frames"
    in_dir.mkdir()
    for i, g in enumerate(frames):
        write_vdb_leafgrids(in_dir / f"f{i}.vdb", [g])
    for name, main, extra in (("ours", cli, CPU), ("theirs", jax_cli, [])):
        rc, enc = _run(main, ["encode-seq", in_dir, tmp_path / f"{name}_seq", "--model", MODEL,
                              *extra, *F32], capsys)
        assert rc == 0 and enc["frames"] == 2 and enc["inputs"] == ["f0.vdb", "f1.vdb"]
        rc, dec = _run(main, ["decode-seq", tmp_path / f"{name}_seq", tmp_path / f"{name}_out",
                              "--model", MODEL, "--vdb", *extra, *F32], capsys)
        assert rc == 0 and dec["frames"] == 2
    for i, g in enumerate(frames):
        f = f"frame_{i:04d}.vqvdb"
        bad = (_indices(tmp_path / "ours_seq" / f) != _indices(tmp_path / "theirs_seq" / f))
        (src,) = read_vdb_leafgrids(in_dir / f"f{i}.vdb")
        assert not (bad.reshape(-1) & ~_near_tie_rows(src.leaves)).any()
        (r,) = read_vdb_leafgrids(tmp_path / "ours_out" / f"frame_{i:04d}.vdb")
        assert r.name == "density"
        np.testing.assert_array_equal(np.sort(r.origins, axis=0), np.sort(g.origins, axis=0))


def test_extract_matches_jax(tmp_path, capsys):
    g = _grid(seed=9, size=32)
    src = tmp_path / "asset.vdb"
    write_vdb_leafgrids(src, [g])
    rc, ours = _run(cli, ["extract", src, tmp_path / "a"], capsys)
    jrc, theirs = _run(jax_cli, ["extract", src, tmp_path / "b"], capsys)
    assert rc == jrc == 0 and ours["leaves"] == theirs["leaves"] == g.num_leaves
    for f in sorted((tmp_path / "b").iterdir()):
        assert (tmp_path / "a" / f.name).read_bytes() == f.read_bytes(), f.name


def test_bench_runs_the_ports_round_trip(capsys):
    from vqvdb_tpu_torch.tools import roundtrip

    rc, out = _run(roundtrip.main, ["--leaves", "48", "--batch-size", "32", *CPU], capsys)
    assert rc == 0 and out["device"] == "cpu" and out["leaves"] == 48
    assert out["psnr_db"] > 30.0 and out["compress_leaves_per_s"] > 0
    assert set(out["host_seconds"]) == {"quantize_residual", "write_frames", "read_frames",
                                        "apply_residual"}


@pytest.mark.parametrize("setting", ["", "dir", "off"], ids=["default", "path", "off"])
def test_compile_cache_chooses_the_kernel_build_dir(tmp_path, monkeypatch, setting):
    """VQVDB_COMPILE_CACHE: unset -> vqvdb_tpu_torch/_build/, a path -> that
    path, off -> None and a fresh temporary directory; the kernels and the
    native LZ4 library are built into the chosen directory."""
    from vqvdb_tpu_torch.ops import build
    from vqvdb_tpu_torch.runtime import native_io
    from vqvdb_tpu_torch.utils.compile_cache import enable_persistent_cache

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)  # restored afterwards
    value = str(tmp_path / "cache") if setting == "dir" else setting
    monkeypatch.setenv("VQVDB_COMPILE_CACHE", value)
    got = enable_persistent_cache()
    if setting == "off":
        assert got is None and build.BUILD_DIR.is_dir()
        assert build.BUILD_DIR != build.PKG_DIR / "_build"
    else:
        want = Path(value) if value else build.PKG_DIR / "_build"
        assert got == str(want) and build.BUILD_DIR == want
    assert build._target("dequantize").parent == build.BUILD_DIR
    assert native_io._target().parent == build.BUILD_DIR
