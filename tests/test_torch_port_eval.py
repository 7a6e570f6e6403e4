"""The port's evaluation (`vqvdb_tpu_torch.eval`, `vdb/grid.split_mse`) and
its `train` / `datagen` / `eval` commands against the JAX package's, on the
CPU in f32.

evaluate_codec and codebook_report must return the JAX dicts: the same keys,
integers and arrays of indices equal, floats within 1e-4 relative (each
package measures its own decode, ~1e-6 apart). The models here are small
random-init ones whose two best scores are never within 1e-5 relative, so
indices compare exactly. The CLI runs in-process; `datagen` must write the
JAX CLI's bytes, a port-trained `.vqmodel` must load in the JAX package, and
`eval` must print the JAX CLI's JSON on it.
"""

import json

import jax
import numpy as np
import pytest
import torch

from vqvdb_tpu.cli import main as jax_cli
from vqvdb_tpu.core.artifact import load_model as jax_load_model
from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.eval import metrics as jmetrics
from vqvdb_tpu.eval import report as jreport
from vqvdb_tpu.models.vqvae import init_vqvae_params as jax_init
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.vdb import grid as jgrid
from vqvdb_tpu_torch.cli import main as cli
from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.eval import metrics, report
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.train.synthetic import smoke_grid
from vqvdb_tpu_torch.vdb import grid

torch.set_num_threads(2)

RTOL = 1e-4
CPU = ["--device", "cpu"]


def assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(y, np.ndarray) and y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-7, err_msg=k)
        elif isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=k)
        elif isinstance(y, float):
            assert x == pytest.approx(y, rel=RTOL, abs=1e-9), k
        else:
            assert x == y, k


@pytest.fixture(scope="module")
def codecs():
    kw = dict(embedding_dim=16, num_embeddings=32, encoder_arch="packed")
    jcfg = JaxModelConfig(**kw)
    jparams = jax.jit(jax_init, static_argnums=1)(jax.random.key(4), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    opts = dict(batch_size=32, compute_dtype="float32")
    return (VQCodec(tree, ModelConfig(**kw), CodecConfig(**opts), device="cpu"),
            JaxCodec(jparams, jcfg, JaxCodecConfig(**opts)))


def test_evaluate_codec_and_codebook_report_match_jax(codecs):
    codec, jcodec = codecs
    leaves = smoke_grid(24, seed=11).leaves[:70]
    leaves[3] = 0.0  # a leaf decoded exactly: its PSNR is inf in both
    mine = metrics.evaluate_codec(codec, leaves, zero_atol=1e-3, max_leaves=60)
    want = jmetrics.evaluate_codec(jcodec, leaves, zero_atol=1e-3, max_leaves=60)
    assert mine["eval_backend"] == want["eval_backend"] == "cpu"
    assert_same_dict(mine, want)
    for dead in (0, 3):
        assert_same_dict(metrics.codebook_report(mine["indices"], 32, dead),
                         jmetrics.codebook_report(want["indices"], 32, dead))
    got = metrics.evaluate_codec(codec, leaves[:10, ..., 0])  # scalar leaves as [N,8,8,8]
    assert got["num_blocks"] == 10 and got["compute_dtype"] == "float32"


def test_split_mse_matches_jax(rng):
    target = rng.random((5, 8, 8, 8, 1)).astype(np.float32)
    target[target < 0.4] = 0.0
    recon = target + rng.normal(0, 0.01, target.shape).astype(np.float32)
    for atol in (0.0, 0.5):
        assert grid.split_mse(recon, target, atol) == jgrid.split_mse(recon, target, atol)
    assert grid.split_mse(target, np.zeros_like(target)) == jgrid.split_mse(
        target, np.zeros_like(target))


def test_write_report_writes_the_jax_files(codecs, tmp_path):
    codec, jcodec = codecs
    leaves = smoke_grid(24, seed=12).leaves[:40]
    outs = []
    for mod, mets, c, name in ((report, metrics, codec, "port"),
                               (jreport, jmetrics, jcodec, "jax")):
        rep = mets.evaluate_codec(c, leaves)
        cb = mets.codebook_report(rep["indices"], 32)
        cb["embedding"] = np.random.default_rng(0).random((32, 16))
        rep["latent_sample"] = np.random.default_rng(1).random((64, 16))
        recon = c.decode_indices(rep["indices"])
        md = mod.write_report(tmp_path / name, rep, cb, sample_leaves=leaves,
                              sample_recon=recon)
        outs.append((sorted(p.name for p in (tmp_path / name).iterdir()), md.read_text()))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1].splitlines()[2:5] == outs[1][1].splitlines()[2:5]
    x = np.random.default_rng(2).random((200, 6))
    np.testing.assert_allclose(np.abs(report._pca2(x)), np.abs(jreport._pca2(x)), atol=1e-9)
    np.testing.assert_allclose(report._fast_ica2(x), jreport._fast_ica2(x), atol=1e-9)


def _run(main, argv, capsys):
    """(exit code, the last JSON object printed, stderr)."""
    rc = main([str(a) for a in argv])
    cap = capsys.readouterr()
    out = cap.out.strip()
    start = out.rfind("\n{")
    return rc, (json.loads(out[start + 1 if start >= 0 else 0:]) if out.endswith("}")
                else None), cap.err


@pytest.mark.parametrize("resident", [False, True], ids=["host", "device_resident"])
def test_cli_datagen_train_eval(tmp_path, capsys, resident):
    rc, got, _ = _run(cli, ["datagen", tmp_path / "data", "--volumes", "2", "--size", "24",
                            "--seed", "5", "--family", "mixed"], capsys)
    jrc, want, _ = _run(jax_cli, ["datagen", tmp_path / "jdata", "--volumes", "2",
                                  "--size", "24", "--seed", "5", "--family", "mixed"], capsys)
    assert rc == jrc == 0 and got["leaves"] == want["leaves"] > 16
    for name in ("vol_000.npy", "vol_001.npy"):
        assert (tmp_path / "data" / name).read_bytes() == (tmp_path / "jdata" / name).read_bytes()

    model = tmp_path / "out" / "m.vqmodel"
    argv = ["train", "--data-dir", tmp_path / "data", "--model-path", model, "--epochs", "2",
            "--batch-size", "8", "--embedding-dim", "16", "--num-embeddings", "32",
            "--encoder-arch", "packed", "--compute-dtype", "float32", *CPU]
    rc, _, _ = _run(cli, argv + (["--device-resident"] if resident else []), capsys)
    assert rc == 0
    history = json.loads(model.with_suffix(".history.json").read_text())
    key = "loss" if resident else "train_recon"
    assert len(history[key]) == 2 and np.isfinite(history[key]).all()
    assert (tmp_path / "out" / "ckpts" / "best").is_dir()
    tree, cfg = load_model(model)
    jparams, jcfg = jax_load_model(model)  # the JAX package reads the port's model
    assert jcfg.encoder_arch == cfg.encoder_arch == "packed"
    np.testing.assert_array_equal(np.asarray(jparams.vq.embedding), tree["vq"]["embedding"])

    ev = ["eval", "--data-dir", tmp_path / "data", "--model", model, "--batch-size", "32",
          "--compute-dtype", "float32"]
    rc, got, _ = _run(cli, ev + CPU + ["--report-dir", tmp_path / "rep"], capsys)
    jrc, want, _ = _run(jax_cli, ev, capsys)
    assert rc == jrc == 0
    assert_same_dict(got, want)
    assert (tmp_path / "rep" / "report.md").exists()

    # Resume: the run is done, so a second call trains no step and exports
    # the same best-val model.
    before = model.read_bytes()
    rc, _, _ = _run(cli, argv + (["--device-resident"] if resident else []), capsys)
    assert rc == 0 and model.read_bytes() == before


def test_cli_train_usage_errors(tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    rc, _, err = _run(cli, ["train", "--data-dir", tmp_path / "empty", *CPU], capsys)
    jrc, _, _ = _run(jax_cli, ["train", "--data-dir", tmp_path / "empty"], capsys)
    assert rc == jrc == 2 and "no .npy files" in err
    rc, _, err = _run(cli, ["train", "--data-dir", tmp_path / "empty", "--data-parallel",
                            *CPU], capsys)
    assert rc == 2 and "no .npy files" in err
    rc, _, err = _run(cli, ["eval", "--data-dir", tmp_path / "empty", "--model", "m",
                            *CPU], capsys)
    assert rc == 2 and "no .npy files" in err
