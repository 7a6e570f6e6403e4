"""The port's data parallelism across processes: gloo ranks on the CPU.

Each rank is a child Python process that imports the port only (no JAX),
joins a group through `init_multi_host` on a file store in the test's
temporary directory (no port to find, so parallel test workers never
collide) and runs, on one seeded global batch / pool / grid:
  * 3 `train_step`s on its `local_batch_slice` (`make_sharded_train_step`);
  * `train_on_device(mesh=)` (3 epochs, a dead-code reset after 2);
  * `train(mesh=)`, the host loop (2 epochs, a reset after each: the
    global batch's z gathered from the ranks);
  * the file codec on a multi-process mesh (each rank its own copy).
World sizes 1, 2 and 4 run at once. Gates, as in tests/test_parallel.py,
test_fast_train.py and test_distributed.py:
  * the ranks of a run end bit-identical to each other;
  * 2 and 4 ranks against 1: train-step loss within rtol 1e-5, params
    within rtol 2e-4 / atol 2e-5; both trainers within rtol 1e-3 / atol
    1e-5 (sums over the group in another order);
  * the multi-process codec's files and decoded leaves equal the
    single-process codec's, byte for byte;
  * the 1-rank step against the JAX package's `make_sharded_train_step` on
    its 8-device mesh within the tolerances of tests/test_torch_port_train.py
    (metrics 1e-5 relative; params by the Adam-step rule; EMA 1e-4 relative
    off near-tie codes).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models.vqvae import init_vqvae_params
from vqvdb_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vqvdb_tpu.parallel.mesh import make_sharded_train_step as jax_sharded_step
from vqvdb_tpu.parallel.mesh import shard_batch as jax_shard_batch
from vqvdb_tpu.train import train as jtrain

REPO = Path(__file__).resolve().parent.parent
KW = dict(embedding_dim=16, num_embeddings=32, encoder_arch="packed")
BATCH = 16
LR = 1e-3
WORLDS = (1, 2, 4)

RANK = r"""
import hashlib, sys
import numpy as np
import torch
rank, world, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
import torch.distributed as dist
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_from_jax, params_to_jax
from vqvdb_tpu_torch.parallel.distributed import (
    global_batch_from_local, init_multi_host, local_batch_slice)
from vqvdb_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.train import train
from vqvdb_tpu_torch.train.data import LeafDataset, find_npy_files
from vqvdb_tpu_torch.train.fast import train_on_device
from vqvdb_tpu_torch.vdb.grid import LeafGrid

info = init_multi_host("file://" + store, world, rank, backend="gloo")
assert info == {"process_index": rank, "process_count": world, "local_devices": 1,
                "global_devices": world}, info
mesh = make_mesh()
assert mesh.size == world and mesh.first_shard == rank and mesh.multiprocess
inp = np.load(f"{work}/inputs.npz")
flat = {k[3:]: inp[k] for k in inp.files if k.startswith("jp/")}
tree = {}
for key, v in flat.items():
    node = tree
    *path, leaf = key.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = v
cfg = ModelConfig(embedding_dim=16, num_embeddings=32, encoder_arch="packed")
out = {}

def put(prefix, params):
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[prefix + "/".join(path)] = np.asarray(node)
    walk(params_to_jax(params), ())

# 1. three train steps on this rank's slice of each global batch
tcfg = train.TrainConfig(batch_size=16, compute_dtype="float32", lr=1e-3)
opt = train.make_optimizer(tcfg, 10)
state = train.make_train_state(cfg, tcfg, 10, "cpu", params=params_from_jax(tree, cfg, "cpu"))
step = make_sharded_train_step(mesh, opt, cfg, tcfg)
losses = []
for i in range(3):
    batch = inp["batches"][i]
    state, metrics, _ = step(state, global_batch_from_local(mesh, batch[local_batch_slice(16)]))
    losses.append([float(metrics[k]) for k in sorted(metrics)])
out["step_metrics"] = np.array(losses)
put("step/", state.params)

# 2. device-resident epochs
fcfg = train.TrainConfig(epochs=3, batch_size=16, compute_dtype="float32", lr=1e-3,
                         dead_code_interval=2, val_fraction=0.25)
fstate, trace = train_on_device(inp["pool"], cfg, fcfg, mesh=mesh, log_fn=lambda *_: None,
                                checkpoint_dir=f"{work}/fast_ckpt_{world}")
out["fast_trace"] = trace
put("fast/", fstate.params)

# 3. the host loop
hcfg = train.TrainConfig(epochs=2, batch_size=16, compute_dtype="float32", lr=1e-3,
                         dead_code_interval=1, val_fraction=0.25)
ds = LeafDataset(find_npy_files(f"{work}/data"))
hstate, hist = train.train(ds, cfg, hcfg, mesh=mesh, log_fn=lambda *_: None)
for k, v in hist.items():
    out["host_hist/" + k] = np.array(v)
put("host/", hstate.params)

# 4. the file codec: every rank reads the same grid and writes its own copy;
# the single-process run also writes the codec's files without a mesh
codecs = {"codec": VQCodec(tree, cfg, CodecConfig(batch_size=8, compute_dtype="float32"),
                           mesh=mesh)}
assert codecs["codec"].check_latent_shape() == (4, 4, 4)
if world == 1:
    codecs["plain"] = VQCodec(tree, cfg, CodecConfig(batch_size=8, compute_dtype="float32"),
                              device="cpu")
grid = LeafGrid("density", inp["origins"], inp["leaves"])
for name, codec in codecs.items():
    for tier, opts in (("v3", {}), ("v6", dict(residual="int8"))):
        path = f"{work}/{name}_{world}_{rank}_{tier}.vqvdb"
        codec.compress(grid, path, **opts)
        (dec,), _ = codec.decompress(path)
        out[f"{name}_{tier}_file"] = np.frombuffer(open(path, "rb").read(), np.uint8)
        out[f"{name}_{tier}_leaves"] = hashlib.sha256(dec.leaves.tobytes()).hexdigest()
np.savez(f"{work}/out_{world}_{rank}.npz", **out)
dist.destroy_process_group()
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "_asdict"):  # the VQState
            v = v._asdict()
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [per-rank outputs]} of the runs at every world size, with the
    JAX params and inputs they started from."""
    work = tmp_path_factory.mktemp("ranks")
    jcfg = JaxModelConfig(**KW)
    jparams = jax.jit(init_vqvae_params, static_argnums=1)(jax.random.key(5), jcfg)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    rng = np.random.default_rng(3)
    batches = rng.random((3, BATCH, 8, 8, 8, 1), np.float32)
    pool = rng.random((80, 8, 8, 8, 1), np.float32)
    n = 21  # a ragged tail over several 8-leaf batches
    origins = (np.stack(np.unravel_index(np.arange(n), (3, 3, 3)), 1) * 8).astype(np.int32)
    leaves = rng.random((n, 8, 8, 8, 1), np.float32)
    np.savez(work / "inputs.npz", batches=batches, pool=pool, origins=origins, leaves=leaves,
             **{"jp/" + k: v for k, v in _flat(tree).items()})
    (work / "data").mkdir()
    for i in range(2):
        np.save(work / "data" / f"v{i}.npy", rng.random((40, 8, 8, 8), np.float32))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        store = work / f"store_{world}"
        for rank in range(world):
            procs.append((world, rank, subprocess.Popen(
                [sys.executable, "-c", RANK, str(rank), str(world), str(store), str(work)],
                cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs = {}
    for world, rank, proc in procs:
        try:
            logs[world, rank] = proc.communicate(timeout=400)[0].decode()[-4000:]
        finally:
            proc.kill()
    for world, rank, proc in procs:
        assert proc.returncode == 0, f"world {world} rank {rank}:\n{logs[world, rank]}"
    out = {w: [dict(np.load(work / f"out_{w}_{r}.npz")) for r in range(w)] for w in WORLDS}
    return out, jparams, jcfg, batches, work


def _keys(run, prefix):
    return [k for k in run if k.startswith(prefix)]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_end_bit_identical(runs, world):
    out = runs[0][world]
    for other in out[1:]:
        assert other.keys() == out[0].keys()
        for k in out[0]:
            if k.startswith("plain"):
                continue  # the single-process codec's, of world 1 alone
            np.testing.assert_array_equal(other[k], out[0][k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_train_steps_match_one_rank(runs, world):
    one, many = runs[0][1][0], runs[0][world][0]
    np.testing.assert_allclose(many["step_metrics"], one["step_metrics"], rtol=1e-5)
    for k in _keys(one, "step/"):
        np.testing.assert_allclose(many[k], one[k], rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("driver", ["fast", "host"])
def test_trainers_match_one_rank(runs, world, driver):
    one, many = runs[0][1][0], runs[0][world][0]
    if driver == "fast":
        np.testing.assert_allclose(many["fast_trace"], one["fast_trace"], rtol=1e-3, atol=1e-5)
        assert many["fast_trace"].shape == (3, 5)
    else:
        for k in _keys(one, "host_hist/"):
            np.testing.assert_allclose(many[k], one[k], rtol=1e-3, atol=1e-5, err_msg=k)
    for k in _keys(one, driver + "/"):
        np.testing.assert_allclose(many[k], one[k], rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_multiprocess_codec_files_equal_one_process(runs, world):
    """Each rank's files and decoded leaves against the codec without a mesh
    in one process (tests/test_distributed.py:159), each run a child with one
    thread: the CPU's f32 sums split by the thread count."""
    out = runs[0]
    plain = out[1][0]
    for tier in ("v3", "v6"):
        for rank in out[world]:
            assert rank[f"codec_{tier}_file"].tobytes() == plain[f"plain_{tier}_file"].tobytes()
            assert rank[f"codec_{tier}_leaves"] == plain[f"plain_{tier}_leaves"], tier


def test_one_rank_step_matches_jax_sharded_step(runs):
    out, jparams, jcfg, batches, _ = runs
    tj = jtrain.TrainConfig(batch_size=BATCH, compute_dtype="float32", lr=LR)
    opt = jtrain.make_optimizer(tj, 10)
    jp = jax.tree.map(jnp.copy, jparams)  # the sharded step donates its state
    state = jtrain.TrainState(jp, opt.init((jp.encoder, jp.decoder)),
                              jnp.asarray(0))
    mesh = jax_make_mesh(8)
    step = jax_sharded_step(mesh, opt, jcfg, tj)
    ties, metrics = set(), []
    for i in range(3):
        emb = np.asarray(state.params.vq.embedding, np.float64)
        state, m, z = step(state, jax_shard_batch(jnp.asarray(batches[i]), mesh))
        metrics.append([float(m[k]) for k in sorted(m)])
        zf = np.asarray(z, np.float64).reshape(-1, emb.shape[1])
        d = (zf * zf).sum(1, keepdims=True) + (emb * emb).sum(1) - 2 * zf @ emb.T
        order = np.argsort(d, axis=1)[:, :2]
        two = np.take_along_axis(d, order, 1)
        ties |= set(order[(two[:, 1] - two[:, 0]) < 1e-5 * np.maximum(1.0, np.abs(two[:, 0]))]
                    .ravel().tolist())
    one = out[1][0]
    np.testing.assert_allclose(one["step_metrics"], np.array(metrics), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, {"encoder": state.params.encoder,
                                           "decoder": state.params.decoder,
                                           "vq": state.params.vq._asdict()}))
    for k, w in want.items():
        got = np.asarray(one["step/" + k], np.float64)
        w = np.asarray(w, np.float64)
        if k.startswith("vq/"):
            keep = np.ones(w.shape[0], bool)
            keep[list(ties)] = False
            np.testing.assert_allclose(got[keep], w[keep], rtol=1e-4,
                                       atol=1e-4 * max(np.abs(w).max(), 1e-3), err_msg=k)
            continue
        diff = np.abs(got - w)
        assert diff.max() <= 2 * 3 * LR, (k, diff.max())
        assert (diff > 1e-2 * 3 * LR).mean() <= 0.01, k
