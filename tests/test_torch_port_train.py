"""The port's training (`vqvdb_tpu_torch.train`, the training halves of
`models/quantizer.py` and `models/vqvae.py`, the initialisers, `save_model`)
against the JAX package's, on the CPU in f32 at small sizes.

Params start as the JAX package's, carried across with `params_from_jax`;
inputs come from seeded numpy. Tolerances:
  * forwards, metrics, EMA statistics: within 1e-5 relative (f32 sums in
    another order); codes equal except where JAX's two best distances are
    within 1e-5 relative (near-ties), whose codes' EMA rows are skipped.
  * gradients: each leaf's largest difference within 2e-5 of the largest
    gradient entry of the whole tree (GroupNorm over nearly constant voxels
    amplifies f32 rounding in a few small leaves, so a per-leaf relative
    bound would be set by that conditioning, not by the port).
  * params after n Adam steps at learning rate lr: per leaf, at most 1% of
    the entries more than 1e-2 * n * lr apart, and none more than 2 * n * lr
    (Adam's steps are +-lr wherever a gradient entry is within f32 rounding
    of zero, whichever package computes it).
The fast path, the resume and the checkpoint tests compare the port with
itself: within 1e-5, bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvdb_tpu.core import artifact as jartifact
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models import quantizer as jq
from vqvdb_tpu.models.vqvae import init_vqvae_params as jax_init
from vqvdb_tpu.train import data as jdata
from vqvdb_tpu.train import synthetic as jsynth
from vqvdb_tpu.train import train as jtrain
from vqvdb_tpu_torch.core import artifact
from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.weights import params_from_jax, params_to_jax
from vqvdb_tpu_torch.models import blocks
from vqvdb_tpu_torch.models import quantizer as q
from vqvdb_tpu_torch.models.vqvae import init_vqvae_params
from vqvdb_tpu_torch.train import data, synthetic, train
from vqvdb_tpu_torch.train.checkpoint import CheckpointManager
from vqvdb_tpu_torch.train.fast import epoch_permutation, train_on_device
from vqvdb_tpu_torch.utils.errors import ArtifactError, ConfigError

torch.set_num_threads(2)

RTOL = 1e-5
NEAR_TIE = 1e-5
PACKED = dict(embedding_dim=16, num_embeddings=32, encoder_arch="packed")
REFERENCE = dict(embedding_dim=16, num_embeddings=32)
RVQ2 = dict(embedding_dim=16, num_embeddings=32, num_quantizers=2, encoder_arch="packed_lite")
VEC3 = dict(in_channels=3, embedding_dim=16, num_embeddings=32, encoder_arch="packed")


def leaves(seed, n, channels=1):
    """n leaves of seeded Gaussian blobs in [0, 1] ([-1, 1] for 3 channels)."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:8, 0:8, 0:8].astype(np.float32)
    out = np.zeros((n, 8, 8, 8, channels), np.float32)
    for i in range(n):
        for _ in range(2):
            c, s = rng.uniform(0, 8, 3), rng.uniform(1.5, 4)
            blob = np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / (2 * s * s))
            out[i] += blob[..., None] * (rng.uniform(-1, 1, channels) if channels > 1 else 1)
    return np.clip(out, -1 if channels > 1 else 0, 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, seed):
    # One compiled init: op by op, JAX compiles each random draw on its own.
    return jax.jit(jax_init, static_argnums=1)(jax.random.key(seed), jcfg)


def models(kw, seed=1):
    """(JAX params, JAX cfg, port params on the CPU, port cfg)."""
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = _jax_params(jcfg, seed)
    return jp, jcfg, params_from_jax(jp._asdict(), cfg, "cpu"), cfg


def jax_tree(jp):
    """A JAX params pytree as nested numpy dicts (vq as a dict)."""
    d = jax.tree.map(np.asarray, {"encoder": jp.encoder, "decoder": jp.decoder})
    d["vq"] = jax.tree.map(np.asarray, jp.vq._asdict())
    return d


def flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def near_tie_codes(z, embedding):
    """Codes that rows of z (JAX's encoder outputs) nearly tie between."""
    zf = np.asarray(z, np.float64).reshape(-1, embedding.shape[-1])
    e = np.asarray(embedding, np.float64)
    d = (zf * zf).sum(1, keepdims=True) + (e * e).sum(1) - 2 * zf @ e.T
    order = np.argsort(d, axis=1)[:, :2]
    two = np.take_along_axis(d, order, 1)
    tie = (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))
    return set(order[tie].ravel().tolist())


def assert_close_tree(got, want, rtol=RTOL, skip_codes=()):
    fg, fw = flat(got), flat(want)
    assert sorted(fg) == sorted(fw)
    for k, w in fw.items():
        a = np.asarray(fg[k], np.float64)
        w = np.asarray(w, np.float64)
        assert a.shape == w.shape, k
        if skip_codes and "vq" in k:
            keep = np.ones(a.shape[-2] if a.ndim > 1 and "cluster" not in k else a.shape[-1], bool)
            keep[list(skip_codes)] = False
            a, w = (a[..., keep, :], w[..., keep, :]) if "cluster" not in k else (a[..., keep], w[..., keep])
        np.testing.assert_allclose(a, w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1e-3),
                                   err_msg=k)


def assert_adam_close(got, want, steps, lr):
    for k, w in flat(want).items():
        d = np.abs(np.asarray(flat(got)[k], np.float64) - w)
        assert d.max() <= 2 * steps * lr, (k, d.max())
        assert (d > 1e-2 * steps * lr).mean() <= 0.01, (k, (d > 1e-2 * steps * lr).mean())


def states(kw, lr=1e-3, total=10, seed=1, **tkw):
    """Matching JAX and port TrainStates (same params), optimizers, configs."""
    jp, jcfg, tree, cfg = models(kw, seed)
    tj = jtrain.TrainConfig(batch_size=8, compute_dtype="float32", lr=lr, **tkw)
    tp = train.TrainConfig(batch_size=8, compute_dtype="float32", lr=lr, **tkw)
    jopt, popt = jtrain.make_optimizer(tj, total), train.make_optimizer(tp, total)
    js = jtrain.TrainState(jp, jopt.init((jp.encoder, jp.decoder)), jnp.asarray(0))
    ps = train.make_train_state(cfg, tp, total, "cpu", params=tree)
    return (js, jopt, jcfg, tj), (ps, popt, cfg, tp)


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages", [1, 2])
def test_train_forward_matches_jax(rng, stages):
    k, d = 32, 16
    if stages == 1:
        jstate = jq.init_vq_state(jax.random.key(3), k, d)
    else:
        jstate = jq.init_rvq_state(jax.random.key(3), stages, k, d)
    z = rng.standard_normal((8, 4, 4, 4, d)).astype(np.float32) * 0.5
    jfwd = jq.vq_train_forward if stages == 1 else jq.rvq_train_forward
    fwd = q.vq_train_forward if stages == 1 else q.rvq_train_forward
    jqz, jnew, jc, jppl = jfwd(jstate, jnp.asarray(z), 0.25, 0.95, 1e-4)
    state = q.VQState(*(torch.from_numpy(np.asarray(x)) for x in jstate))
    zt = torch.from_numpy(z).requires_grad_()
    qz, new, c, ppl = fwd(state, zt, 0.25, 0.95, 1e-4)
    ties = near_tie_codes(z, np.asarray(jstate.embedding).reshape(-1, d)[:k])
    assert not ties  # these inputs hold none: every code and row compares
    np.testing.assert_allclose(qz.detach().numpy(), np.asarray(jqz), rtol=RTOL, atol=1e-6)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-6)
    assert float(c) == pytest.approx(float(jc), rel=RTOL)
    assert float(ppl) == pytest.approx(float(jppl), rel=RTOL)
    # The estimator: d(sum q)/dz = 1, and the commitment's gradient
    # 2 beta (z - q) / n (averaged over stages), as jax.grad gives them.
    jg = jax.grad(lambda zz: jnp.sum(jfwd(jstate, zz, 0.25, 0.95, 1e-4)[0])
                  + jfwd(jstate, zz, 0.25, 0.95, 1e-4)[2])(jnp.asarray(z))
    (g,) = torch.autograd.grad(qz.sum() + c, zt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-8)


def test_batch_stats_and_ema_update_match_jax(rng):
    z = rng.standard_normal((500, 16)).astype(np.float32)
    idx = rng.integers(0, 32, 500)
    jc, js = jq.batch_stats(jnp.asarray(z), jnp.asarray(idx), 32)
    c, s = q.batch_stats(torch.from_numpy(z), torch.from_numpy(idx), 32)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL, atol=1e-5)
    jstate = jq.init_vq_state(jax.random.key(0), 32, 16)
    new = q.ema_update(q.VQState(*(torch.from_numpy(np.asarray(x)) for x in jstate)), c, s,
                       0.95, 1e-4)
    for a, b in zip(new, jq.ema_update(jstate, jc, js, 0.95, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-6)
    dist = q.pairwise_sq_distances(torch.from_numpy(z), new.embedding)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jq.pairwise_sq_distances(
        jnp.asarray(z), jnp.asarray(new.embedding.numpy()))), rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("stages", [1, 2])
def test_reset_dead_codes_takes_rows_for_dead_codes_only(rng, stages):
    k, d = 32, 16
    gen = torch.Generator().manual_seed(0)
    state = (q.init_vq_state(gen, k, d) if stages == 1
             else q.init_rvq_state(gen, stages, k, d))
    dead = rng.random(state.cluster_size.shape) < 0.4
    state = state._replace(cluster_size=torch.where(torch.from_numpy(dead), 0.5, 3.0))
    flat_z = torch.from_numpy(rng.standard_normal((300, d)).astype(np.float32))
    fn = q.reset_dead_codes if stages == 1 else q.rvq_reset_dead_codes
    new, n_dead = fn(torch.Generator().manual_seed(1), state, flat_z)
    assert int(n_dead) == dead.sum()
    res = flat_z.clone()
    for s in range(stages):
        pick = (lambda t: t) if stages == 1 else (lambda t, s=s: t[s])
        dead_s = dead if stages == 1 else dead[s]
        emb, avg, cs = pick(new.embedding), pick(new.embed_avg), pick(new.cluster_size)
        old = pick(state.embedding)
        assert torch.equal(emb[~dead_s], old[~dead_s])  # live codes untouched
        assert torch.equal(cs[~dead_s], pick(state.cluster_size)[~dead_s])
        assert (cs[dead_s] == 1.0).all() and torch.equal(avg[dead_s], emb[dead_s])
        for row in emb[dead_s]:  # each dead code took a row of what its stage codes
            assert (res == row).all(1).any()
        res = res - q.dequantize(q.nearest_indices(res, emb), emb)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [PACKED, REFERENCE, RVQ2, VEC3],
                         ids=["packed", "reference", "rvq2", "vec3"])
def test_forward_loss_grads_match_jax(kw):
    jp, jcfg, tree, cfg = models(kw)
    batch = leaves(0, 8, kw.get("in_channels", 1))
    tj = jtrain.TrainConfig(compute_dtype="float32", grad_loss_weight=0.3)
    tp = train.TrainConfig(compute_dtype="float32", grad_loss_weight=0.3)
    loss_fn = jax.jit(jax.value_and_grad(
        lambda t, vq, b: jtrain._forward_loss(t, vq, b, jcfg, tj, None), has_aux=True))
    (jloss, (_, jm, _)), jg = loss_fn((jp.encoder, jp.decoder), jp.vq, jnp.asarray(batch))
    trainable = train.tree_map(lambda t: t.detach().requires_grad_(),
                               {"encoder": tree["encoder"], "decoder": tree["decoder"]})
    loss, (_, m, _) = train._forward_loss(trainable, q.VQState(**tree["vq"]),
                                          torch.from_numpy(batch), cfg, tp)
    grads = torch.autograd.grad(loss, train.tree_leaves(trainable))
    assert float(loss) == pytest.approx(float(jloss), rel=RTOL)
    for key in jm:
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=RTOL), key
    got = params_to_jax(train.tree_unflatten(trainable, grads))
    want = jax.tree.map(np.asarray, {"encoder": jg[0], "decoder": jg[1]})
    scale = max(float(np.abs(g).max()) for g in flat(want).values())
    for key, w in flat(want).items():
        assert np.abs(flat(got)[key] - w).max() <= 2e-5 * scale, key


@pytest.mark.parametrize("kw,sobel", [(PACKED, 0.0), (PACKED, 0.5), (REFERENCE, 0.0),
                                      (RVQ2, 0.5)],
                         ids=["packed", "packed-sobel", "reference", "rvq2-sobel"])
def test_three_train_steps_match_jax(kw, sobel):
    lr = 1e-3
    (js, jopt, jcfg, tj), (ps, popt, cfg, tp) = states(kw, lr=lr, grad_loss_weight=sobel)
    jstep = jax.jit(lambda s, b: jtrain.train_step(s, b, jopt, jcfg, tj))
    ties = set()
    for i in range(3):
        batch = leaves(10 + i, 8)
        emb = np.asarray(js.params.vq.embedding).reshape(-1, cfg.num_embeddings, 16)[0]
        js, jm, jz = jstep(js, jnp.asarray(batch))
        ps, m, z = train.train_step(ps, torch.from_numpy(batch), popt, cfg, tp)
        ties |= near_tie_codes(jz, emb)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=RTOL, atol=1e-5)
        for key in jm:
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=RTOL), (i, key)
    assert ps.step == int(js.step) == 3 and ps.opt_state["count"] == 3
    got, want = params_to_jax(ps.params), jax_tree(js.params)
    assert_adam_close({k: got[k] for k in ("encoder", "decoder")},
                      {k: want[k] for k in ("encoder", "decoder")}, 3, lr)
    assert_close_tree(got["vq"], want["vq"], rtol=1e-4, skip_codes=ties)
    # The optimizer's moments are JAX's, up to the gradients' rounding.
    mu = jax.tree.map(np.asarray, {"encoder": js.opt_state[0].mu[0],
                                   "decoder": js.opt_state[0].mu[1]})
    got_mu = params_to_jax(ps.opt_state["mu"])
    scale = max(float(np.abs(v).max()) for v in flat(mu).values())
    for key, w in flat(mu).items():
        assert np.abs(flat(got_mu)[key] - w).max() <= 2e-5 * scale, key


def test_adamw_matches_optax(rng):
    """The written-out AdamW on random gradients, 5 steps across the cosine
    schedule's end: params within 1e-6 relative of optax's."""
    p0 = {"a": rng.standard_normal((7, 5)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 10.0 ** -s
              for k, v in p0.items()} for s in range(5)]
    jopt = optax.adamw(optax.cosine_decay_schedule(1e-2, 3), b1=0.9, b2=0.999,
                       weight_decay=1e-2)
    opt = train.AdamW(lr=1e-2, total_steps=3, weight_decay=1e-2)
    jp, js = jax.tree.map(jnp.asarray, p0), None
    js = jopt.init(jp)
    pt = {k: torch.from_numpy(v) for k, v in p0.items()}
    st = opt.init(pt)
    for g in grads:
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        new, st = opt.update([torch.from_numpy(g[k]) for k in pt], st, list(pt.values()))
        pt = dict(zip(pt, new))
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [PACKED, RVQ2], ids=["packed", "rvq2"])
def test_eval_step_matches_jax(kw):
    jp, jcfg, tree, cfg = models(kw)
    batch = leaves(3, 8)
    want = jtrain.eval_step(jp, jnp.asarray(batch), jcfg,
                            jtrain.TrainConfig(compute_dtype="float32"))
    got = train.eval_step(tree, torch.from_numpy(batch), cfg,
                          train.TrainConfig(compute_dtype="float32"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=RTOL), key


def test_mesh_raises_naming_item_13(tmp_path):
    """Both trainers refuse a mesh of several devices in one process
    (training runs one process per device) and say how to launch one."""
    from vqvdb_tpu_torch.parallel.mesh import make_mesh

    ds = dataset(tmp_path, n_volumes=1)
    for fn, arg in ((train.train, ds), (train_on_device, np.zeros((16, 8, 8, 8), np.float32))):
        with pytest.raises(ConfigError, match="one process per device"):
            fn(arg, ModelConfig(**PACKED), train.TrainConfig(), mesh=make_mesh(2, "cpu"))


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def dataset(tmp_path, n_volumes=2, size=24):
    paths = synthetic.make_leaf_dataset_files(tmp_path / "data", n_volumes=n_volumes,
                                              size=size, seed=7)
    return data.LeafDataset(paths)


def test_data_and_synthetic_match_jax(tmp_path):
    assert synthetic.train_seeds(5, start=998) == jsynth.train_seeds(5, start=998) \
        == [998, 999, 2000, 2001, 2002]
    mine = synthetic.make_leaf_dataset_files(tmp_path / "a", n_volumes=2, size=24, seed=3,
                                             family="mixed")
    want = jsynth.make_leaf_dataset_files(tmp_path / "b", n_volumes=2, size=24, seed=3,
                                          family="mixed")
    for a, b in zip(mine, want):
        assert a.read_bytes() == b.read_bytes()
    v = synthetic.velocity_volume(16, seed=2)
    np.testing.assert_array_equal(v, jsynth.velocity_volume(16, seed=2))
    ds, jds = data.LeafDataset(mine), jdata.LeafDataset(want)
    (tr, va), (jtr, jva) = ds.split(0.25, seed=4), jds.split(0.25, seed=4)
    for a, b in zip(tr.batches(8, shuffle=True, seed=4, epoch=2),
                    jtr.batches(8, shuffle=True, seed=4, epoch=2)):
        np.testing.assert_array_equal(a, b)
    assert data.find_npy_files(tmp_path / "a") == mine


def test_train_epoch_history_matches_jax(tmp_path, monkeypatch):
    """One epoch of the host loop on the same dataset from the same params:
    the same batches in the same order (train/data.py), so the history
    matches JAX's."""
    jp, jcfg, tree, cfg = models(PACKED)
    paths = synthetic.make_leaf_dataset_files(tmp_path / "d", n_volumes=3, size=32, seed=7)
    kw = dict(epochs=1, batch_size=8, compute_dtype="float32", lr=1e-3,
              dead_code_interval=10, val_fraction=0.25)

    def jax_state(key, mcfg, tcfg, total):
        params = jax.tree.map(jnp.copy, jp)  # the JAX loop donates its state
        opt = jtrain.make_optimizer(tcfg, total)
        return jtrain.TrainState(params, opt.init((params.encoder, params.decoder)),
                                 jnp.asarray(0))

    monkeypatch.setattr(jtrain, "make_train_state", jax_state)
    _, jhist = jtrain.train(jdata.LeafDataset(paths), jcfg, jtrain.TrainConfig(**kw),
                            log_fn=lambda *_: None)
    make = train.make_train_state
    monkeypatch.setattr(train, "make_train_state",
                        lambda m, t, n, dev: make(m, t, n, dev, params=tree))
    ds = data.LeafDataset(paths)
    state, hist = train.train(ds, cfg, train.TrainConfig(**kw), device="cpu",
                              log_fn=lambda *_: None)
    assert sorted(hist) == sorted(jhist) and np.isfinite(hist["val_loss"]).all()
    for key in jhist:
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4, err_msg=key)
    assert state.step == len(ds.split(0.25)[0]) // 8 >= 4


def test_fast_path_equals_host_loop_over_its_permutation(tmp_path):
    pool = np.concatenate([leaves(s, 20) for s in range(2)])
    cfg = ModelConfig(**PACKED)
    tcfg = train.TrainConfig(epochs=2, batch_size=8, compute_dtype="float32", lr=1e-3,
                             dead_code_interval=1, val_fraction=0.2)
    state, trace = train_on_device(pool, cfg, tcfg, device="cpu", log_fn=lambda *_: None)
    assert trace.shape == (2, 5) and np.isfinite(trace).all()
    # The host loop over the same batches: the split, each epoch's
    # permutation, and the reset between the epochs from the pool's first batch.
    split = np.random.default_rng(0).permutation(len(pool))
    train_pool = torch.from_numpy(pool[split[8:]])
    steps = len(train_pool) // 8
    opt = train.make_optimizer(tcfg, steps * 2)
    ref = train.make_train_state(cfg, tcfg, steps * 2, "cpu")
    rows = []
    for e in range(2):
        perm = epoch_permutation(tcfg, len(train_pool), e, torch.device("cpu"))
        acc = []
        for i in range(steps):
            ref, m, _ = train.train_step(ref, train_pool[perm[i * 8:(i + 1) * 8]], opt, cfg, tcfg)
            acc.append([float(m[k]) for k in ("loss", "recon_err", "vq_loss", "perplexity")])
        val = float(train.eval_step(ref.params, torch.from_numpy(pool[split[:8]]), cfg,
                                    tcfg)["loss"])
        rows.append(list(np.mean(acc, 0)) + [val])
        if e == 0:
            from vqvdb_tpu_torch.models.vqvae import encoder_apply

            z = encoder_apply(ref.params["encoder"], train_pool[:8], cfg).detach()
            ref, _ = train.apply_reset(ref, train.generator(torch.device("cpu"), 0, 1, 0),
                                       z, cfg)
    np.testing.assert_allclose(trace, np.array(rows), rtol=1e-5)
    for key, w in flat(params_to_jax(ref.params)).items():
        np.testing.assert_allclose(flat(params_to_jax(state.params))[key], w, rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("fast", [False, True], ids=["host", "device_resident"])
def test_resume_equals_uninterrupted(tmp_path, fast):
    """Train 3 epochs; train again, drop the last checkpoint, resume: the
    same params bit for bit (a dead-code reset falls between)."""
    cfg = ModelConfig(**PACKED)
    tcfg = train.TrainConfig(epochs=3, batch_size=8, compute_dtype="float32", lr=1e-3,
                             dead_code_interval=1, val_fraction=0.25, max_checkpoints=5)
    pool_ds = dataset(tmp_path)
    pool = pool_ds.gather(np.arange(len(pool_ds)))

    def run(ckpt, resume=True):
        quiet = dict(log_fn=lambda *_: None, device="cpu", checkpoint_dir=str(ckpt),
                     resume=resume)
        if fast:
            return train_on_device(pool, cfg, tcfg, **quiet)[0]
        return train.train(pool_ds, cfg, tcfg, **quiet)[0]

    full = run(tmp_path / "a")
    run(tmp_path / "b")
    manager = CheckpointManager(tmp_path / "b")
    steps = manager.all_steps()
    assert len(steps) == 3
    import shutil

    shutil.rmtree(tmp_path / "b" / f"step_{steps[-1]:010d}")
    resumed = run(tmp_path / "b")
    assert resumed.step == full.step == steps[-1]
    for a, b in zip(train.tree_leaves(resumed.params), train.tree_leaves(full.params)):
        assert torch.equal(a, b)
    assert resumed.opt_state["count"] == full.opt_state["count"]


def test_checkpoint_manager(tmp_path):
    cfg = ModelConfig(**PACKED)
    tcfg = train.TrainConfig()
    state = train.make_train_state(cfg, tcfg, 10, "cpu")
    manager = CheckpointManager(tmp_path / "c", max_to_keep=2)
    for step in (1, 2, 3):
        manager.save(step, state._replace(step=step), metrics={"best_val": float(step)})
    assert manager.all_steps() == [2, 3] and manager.latest_step() == 3
    assert manager.read_metrics(3) == {"best_val": 3.0} and manager.read_metrics(1) is None
    manager.save_best(2, state._replace(step=2), metrics={"val_loss": 0.5})
    manager.save(4, state._replace(step=4))
    assert (tmp_path / "c" / "best").is_dir() and manager.all_steps() == [3, 4]
    step, best = manager.restore_best(state)
    assert step == 2 and best.step == 2
    assert manager.read_best_metrics() == {"val_loss": 0.5, "step": 2}
    step, latest = manager.restore_latest(state)
    assert step == 4
    for a, b in zip(train.tree_leaves(latest.params), train.tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert latest.params["encoder"]["stem_conv"]["w"].is_contiguous(
        memory_format=torch.channels_last_3d)
    other = train.make_train_state(ModelConfig(**RVQ2), tcfg, 10, "cpu")
    with pytest.raises(ArtifactError, match="does not match"):
        manager.restore(4, other)
    (tmp_path / "c" / "step_0000000009").mkdir()  # an orbax-style directory
    with pytest.raises(ArtifactError, match="not a checkpoint"):
        manager.restore(9, state)


# ---------------------------------------------------------------------------
# Params, initialisers, the artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [PACKED, RVQ2, REFERENCE, VEC3, dict(in_channels=3)],
                         ids=["packed", "rvq2", "reference", "vec3", "vec3_reference"])
def test_init_matches_jax_shapes_and_bounds(kw):
    """JAX's random streams cannot be reproduced: the port's init has the
    JAX tree's keys in order, shapes and dtypes, and each leaf the
    distribution's bounds and spread."""
    gen = torch.Generator().manual_seed(0)
    got = params_to_jax(init_vqvae_params(gen, ModelConfig(**kw)))
    want = jax_tree(_jax_params(JaxModelConfig(**kw), 0))
    assert list(flat(got)) == list(flat(want))
    for key, w in flat(want).items():
        a = flat(got)[key]
        assert a.shape == w.shape and a.dtype == w.dtype, key
        if a.size >= 256:
            assert np.abs(a).max() <= 1.5 * np.abs(w).max() + 1e-6, key
            assert a.std() == pytest.approx(w.std(), rel=0.25, abs=1e-4), key
    emb = got["vq"]["embedding"]
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-6)


def test_initialisers():
    gen = torch.Generator().manual_seed(0)
    p = blocks.init_conv3d(gen, 4, 8, 3)
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / (4 * 27))
    assert p["w"].shape == (8, 4, 3, 3, 3) and p["w"].abs().max() <= bound
    assert p["w"].is_contiguous(memory_format=torch.channels_last_3d)
    assert p["b"].abs().max() <= 1 / np.sqrt(4 * 27)
    z = blocks.init_conv3d_near_zero(gen, 8, 8, 1)
    assert z["w"].std() == pytest.approx(1e-3, rel=0.3) and not z["b"].any()
    icnr = blocks.init_conv3d_icnr(gen, 4, 16, 3)
    w = icnr["w"]
    assert torch.equal(w[0], w[7]) and not torch.equal(w[7], w[8])
    with pytest.raises(ValueError):
        blocks.init_conv3d_icnr(gen, 4, 4, 3)
    lin = blocks.init_linear(gen, 8, 2)
    assert lin["w"].shape == (8, 2) and lin["b"].shape == (2,)
    assert blocks.init_channel_attention(gen, 8)["fc1"]["w"].shape == (8, 2)
    assert torch.equal(blocks.init_group_norm(8)["scale"], torch.ones(8))


@pytest.mark.parametrize("kw", [PACKED, RVQ2], ids=["packed", "rvq2"])
def test_save_model_byte_identical_to_jax(tmp_path, kw):
    jp, jcfg, tree, cfg = models(kw)
    artifact.save_model(tmp_path / "port.vqmodel", tree, cfg)
    jartifact.save_model(tmp_path / "jax.vqmodel", jp, jcfg)
    assert (tmp_path / "port.vqmodel").read_bytes() == (tmp_path / "jax.vqmodel").read_bytes()
    # A model the port trained loads in the JAX package, leaf for leaf.
    (_, _, _, _), (ps, popt, pcfg, tp) = states(kw)
    ps, _, _ = train.train_step(ps, torch.from_numpy(leaves(5, 8)), popt, pcfg, tp)
    artifact.save_model(tmp_path / "trained.vqmodel", ps.params, pcfg)
    loaded, lcfg = jartifact.load_model(tmp_path / "trained.vqmodel")
    assert dataclasses.asdict(lcfg) == dataclasses.asdict(cfg)
    for key, w in flat(params_to_jax(ps.params)).items():
        np.testing.assert_array_equal(flat(jax_tree(loaded))[key], w, err_msg=key)
    tree2, _ = artifact.load_model(tmp_path / "trained.vqmodel")
    for key, w in flat(params_to_jax(ps.params)).items():
        np.testing.assert_array_equal(flat(tree2)[key], w, err_msg=key)
