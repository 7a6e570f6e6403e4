"""The port's bench (`vqvdb_tpu_torch/bench.py`, `cli bench`) against the
JAX package's `bench.py`, on the CPU in f32.

The flagship's configuration (packed encoder, D=128, K=256) with the JAX
package's untrained weights, the same in both, at batch 8. The JAX loops
are rebuilt from `bench.py`'s own perturb and consume functions (their
source, read from its AST) as `tests/test_bench_surface.py` rebuilds its
dense loops. The port's loops (`FencedLoop`, `dense_decode_loop`,
`dense_encode_loop`) must agree: decode sums within rtol 1e-5, decoded
leaves within 1e-5, indices equal except on near-tie rows (best and
runner-up JAX scores within 1e-5 relative, as in
`tests/test_torch_port_codec.py`). Its JSON line has every key of
`bench.py`'s, and its FLOP constants are `bench.py`'s.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models.vqvae import encoder_features as jax_encoder_features
from vqvdb_tpu.models.vqvae import init_vqvae_params
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.runtime.dense import _blocks_to_dense as jax_blocks_to_dense
from vqvdb_tpu.runtime.dense import _pad_steps as jax_pad_steps
from vqvdb_tpu.runtime.dense import _scan_scatter as jax_scan_scatter
from vqvdb_tpu.runtime.dense import _to_blocks as jax_to_blocks
from vqvdb_tpu_torch import bench
from vqvdb_tpu_torch.cli import main as cli
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.runtime.codec import VQCodec

torch.set_num_threads(2)

BENCH = Path(__file__).parent.parent / "bench.py"
BATCH = 8
ITERS = 3
RTOL = 1e-5
ATOL = 1e-5
NEAR_TIE = 1e-5
K = 256
DENSE_BLOCKS = (3, 2, 2)  # 12 blocks: a full step of 8 and a padded one
TINY = dict(batch=BATCH, decode_steps=2, encode_steps=2, baseline_steps=2,
            baseline_batch=BATCH)
TINY_EXTRA = dict(TINY, extra_rows=True, vec3_batch=BATCH, vec3_steps=(2, 2),
                  rvq2_batch=BATCH, rvq2_steps=(2, 2), dense_blocks=DENSE_BLOCKS,
                  dense_batch=BATCH, dense_payloads=2, dense_encode_reps=1,
                  dense_steps=2)


def _bench_main():
    tree = ast.parse(BENCH.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_bench_functions():
    """bench.py's perturb_idx, perturb_leaves and consume_f, built from
    their source in its main() (K bound to the model's codebook size)."""
    src = BENCH.read_text()
    ns = {"jnp": jnp, "K": K}
    for node in ast.walk(_bench_main()):
        if isinstance(node, ast.FunctionDef) and node.name in (
                "perturb_idx", "perturb_leaves", "consume_f"):
            exec(ast.get_source_segment(src, node), ns)
    return ns["perturb_idx"], ns["perturb_leaves"], ns["consume_f"]


def _jax_scan(step, x0, n, perturb):
    """bench.py's loop body run n times from x0, each iteration's input and
    output stacked."""
    def body(x, _):
        return perturb(x), (x, step(x))
    return jax.jit(lambda x: jax.lax.scan(body, x, None, length=n)[1])(x0)


def _recording(consume, seen):
    def rec(out):
        seen.append(tuple(t.clone() for t in bench._tensors(out)))
        return consume(out)
    return rec


def _assert_off_near_ties(got, ref, scores):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    part = np.sort(scores, axis=1)[:, :2]
    ties = (part[:, 1] - part[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(part[:, 0]))
    bad = got != ref
    assert not (bad & ~ties).any(), f"{int((bad & ~ties).sum())} rows differ off near-ties"


@pytest.fixture(scope="module")
def codecs():
    kw = dict(encoder_arch="packed")
    jcfg = JaxModelConfig(**kw)
    jparams = jax.jit(init_vqvae_params, static_argnums=1)(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    opts = dict(batch_size=BATCH, compute_dtype="float32")
    return (VQCodec(tree, ModelConfig(**kw), CodecConfig(**opts), device="cpu"),
            JaxCodec(jparams, jcfg, JaxCodecConfig(**opts)), jparams, jcfg)


def _scores(jparams, jcfg, jcodec, leaves):
    h = np.asarray(jax_encoder_features(jparams.encoder, jnp.asarray(leaves), jcfg))
    m, c = jcodec._score_mc
    return h.reshape(-1, h.shape[-1]) @ np.asarray(m) + np.asarray(c)


def test_decode_loop_sum_matches_jax(codecs):
    codec, jcodec, jparams, _ = codecs
    perturb_idx, _, consume_f = _jax_bench_functions()
    idx = np.random.default_rng(0).integers(0, K, (BATCH, 4, 4, 4)).astype(np.uint8)

    def loop(x0):
        def body(i, carry):
            x, acc = carry
            return perturb_idx(x), acc + consume_f(jcodec._decode_step(jparams, x))
        return jax.lax.fori_loop(0, ITERS, body, (x0, jnp.float32(0.0)))[1]

    want = float(jax.jit(loop)(jnp.asarray(idx)))
    got = bench.FencedLoop(codec._decode_step, torch.from_numpy(idx),
                           bench.perturb_indices(K), bench.consume_sum).run(ITERS)
    assert got == pytest.approx(want, rel=RTOL)


def test_encode_loop_indices_match_jax(codecs):
    codec, jcodec, jparams, jcfg = codecs
    _, perturb_leaves, _ = _jax_bench_functions()
    leaves = np.random.default_rng(1).random((BATCH, 8, 8, 8, 1), np.float32)
    xs, want = _jax_scan(lambda x: jcodec._encode_step(jparams, x), jnp.asarray(leaves),
                         ITERS, perturb_leaves)
    seen = []
    bench.FencedLoop(codec._encode_step, torch.from_numpy(leaves), bench.perturb_leaves,
                     _recording(bench.consume_sum, seen)).run(ITERS)
    assert len(seen) == ITERS
    for i, (got,) in enumerate(seen):
        assert got.dtype == torch.uint8 and tuple(got.shape) == (BATCH, 4, 4, 4)
        _assert_off_near_ties(got.numpy(), want[i], _scores(jparams, jcfg, jcodec, xs[i]))


def test_dense_decode_loop_matches_jax_replica(codecs):
    codec, jcodec, jparams, jcfg = codecs
    perturb_idx, _, _ = _jax_bench_functions()
    n = int(np.prod(DENSE_BLOCKS))
    idx = np.random.default_rng(2).integers(0, K, (n, 4, 4, 4)).astype(np.uint8)
    bid_steps = jnp.asarray(jax_pad_steps(np.arange(n, dtype=np.int32), BATCH, n))

    def body(idx_s):
        buf = jnp.zeros((n + 1, 512), jnp.float32)
        buf = jax_scan_scatter(jcodec, buf, idx_s, bid_steps, None, None, jparams, None)
        return buf, jax_blocks_to_dense(buf, n, DENSE_BLOCKS, 1)

    _, (bufs, dense) = _jax_scan(body, jnp.asarray(jax_pad_steps(idx, BATCH, 0)), 2,
                                 perturb_idx)
    step, x0, perturb, consume = bench.dense_decode_loop(codec, idx, DENSE_BLOCKS)
    assert tuple(x0.shape) == (2, BATCH, 4, 4, 4)
    seen = []
    acc = bench.FencedLoop(step, x0, perturb, _recording(consume, seen)).run(2)
    for i, (buf, vol) in enumerate(seen):
        np.testing.assert_allclose(buf[:n].numpy(), np.asarray(bufs[i])[:n], atol=ATOL, rtol=0)
        np.testing.assert_allclose(vol.numpy(), np.asarray(dense[i]), atol=ATOL, rtol=0)
    want = sum(float(np.asarray(bufs[i], np.float64).sum() + dense[i][0, 0, 0, 0])
               for i in range(2))
    assert acc == pytest.approx(want, rel=RTOL)


def test_dense_encode_loop_matches_jax_replica(codecs):
    codec, jcodec, jparams, jcfg = codecs
    _, perturb_leaves, _ = _jax_bench_functions()
    vol = np.random.default_rng(3).random((24, 16, 16, 1)).astype(np.float32)
    n = int(np.prod(DENSE_BLOCKS))
    bid_steps = jnp.asarray(jax_pad_steps(np.arange(n, dtype=np.int32), BATCH, n))

    def body(dense):
        rows = jax_to_blocks(dense)
        act = jnp.max(jnp.abs(rows - jnp.float32(0.0)), axis=1) > jnp.float32(0.0)

        def one(_, bid_b):
            leaves = rows[bid_b].reshape(bid_b.shape[0], 8, 8, 8, 1)
            return None, jcodec._encode_step(jparams, leaves)

        return jax.lax.scan(one, None, bid_steps)[1], act

    xs, (want, want_act) = _jax_scan(body, jnp.asarray(vol), 2, perturb_leaves)
    step, x0, perturb, consume = bench.dense_encode_loop(codec, torch.from_numpy(vol))
    seen = []
    bench.FencedLoop(step, x0, perturb, _recording(consume, seen)).run(2)
    clamped = np.minimum(np.asarray(bid_steps).reshape(-1), n - 1)  # JAX's gather
    for i, (idx, act) in enumerate(seen):
        assert tuple(idx.shape) == (2, BATCH, 4, 4, 4) and idx.dtype == torch.uint8
        assert np.array_equal(act.numpy(), np.asarray(want_act[i]))
        blocks = np.asarray(jax_to_blocks(xs[i]))[clamped].reshape(-1, 8, 8, 8, 1)
        _assert_off_near_ties(idx.numpy(), want[i], _scores(jparams, jcfg, jcodec, blocks))


def _bench_py_keys():
    """The keys of bench.py's line: its `out` dict and its `extra` rows."""
    keys, extra = set(), set()
    for node in ast.walk(_bench_main()):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if (isinstance(target, ast.Name) and target.id == "out"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
            if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                    and target.value.id == "extra"):
                extra.add(target.slice.value)
    return keys, extra


def test_json_line_has_bench_py_keys_and_nulls_off_the_card():
    keys, extra = _bench_py_keys()
    assert {"metric", "value", "vs_baseline", "decode_mfu"} <= keys and len(extra) == 9
    out = bench.run("cpu", **TINY_EXTRA)
    assert keys | extra <= set(out)
    assert out["metric"] == "decode_leaves_per_sec_per_chip" and out["unit"] == "leaves/s"
    assert out["device"] == "cpu" and out["encoder_arch"] == "packed"
    assert out["decode_mfu"] is None and out["encode_mfu"] is None
    assert out["peak_bf16_tflops"] is None
    assert len(out["baseline_runs"]) == bench.BASELINE_RUNS
    rates = [v for k, v in out.items() if k == "value" or k.endswith(("_per_sec", "_per_chip"))]
    assert len(rates) == 11 and all(np.isfinite(r) and r > 0 for r in rates)


def test_flop_constants_are_bench_py_s():
    consts = {}
    for node in ast.parse(BENCH.read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("DECODE_MFLOP_PER_LEAF", "ENCODE_MFLOP_PER_LEAF", "BASELINE_COMPILES"):
                consts[name] = ast.literal_eval(node.value)
    assert consts["DECODE_MFLOP_PER_LEAF"] == bench.DECODE_MFLOP_PER_LEAF
    assert consts["ENCODE_MFLOP_PER_LEAF"] == bench.ENCODE_MFLOP_PER_LEAF
    assert consts["BASELINE_COMPILES"] == bench.BASELINE_RUNS


def test_cli_bench_on_the_cpu_prints_one_line(capsys, monkeypatch):
    monkeypatch.setattr(bench, "OFF_CARD", dataclasses.replace(bench.OFF_CARD, **TINY))
    assert cli(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert _bench_py_keys()[0] <= set(out) and out["device"] == "cpu"
    assert out["value"] > 0 and out["encode_leaves_per_sec_per_chip"] > 0


def test_cli_bench_without_a_card_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli(["bench"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
