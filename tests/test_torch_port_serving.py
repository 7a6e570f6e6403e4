"""The port's HTTP service and stage profiler (`vqvdb_tpu_torch.serving`,
`vqvdb_tpu_torch.utils.profiler`) against the JAX package's, on the CPU.

Both services run live on port 0 over the same small model (the shape of
the JAX package's serving-test model: reference arch, D=32, K=64, batch 32;
weights from the port's seeded initialiser) in f32.
Indices must be equal except on near-tie rows (best and runner-up JAX
scores within NEAR_TIE relative); leaves decoded from the same indices
within ATOL; JSON bodies of /healthz and of the 400 / 404 / 413 answers
equal. A served response must equal the port codec's own call on the same
rows, bit for bit: at a fixed padded shape no row depends on its batch
neighbours.
"""

import http.client
import io
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.core.config import CodecConfig as JaxCodecConfig
from vqvdb_tpu.core.config import ModelConfig as JaxModelConfig
from vqvdb_tpu.models.quantizer import VQState
from vqvdb_tpu.models.vqvae import VQVAEParams
from vqvdb_tpu.models.vqvae import encoder_apply as jax_encoder_apply
from vqvdb_tpu.runtime.codec import VQCodec as JaxCodec
from vqvdb_tpu.serving import CodecService as JaxService
from vqvdb_tpu.serving import make_server as jax_make_server
from vqvdb_tpu.train.synthetic import smoke_volume
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_to_jax
from vqvdb_tpu_torch.format.vqvdb import VqvdbReader
from vqvdb_tpu_torch.models.vqvae import init_vqvae_params
from vqvdb_tpu_torch.runtime.codec import VQCodec
from vqvdb_tpu_torch.serving import CodecService, make_server
from vqvdb_tpu_torch.utils.profiler import Profiler

torch.set_num_threads(2)

NEAR_TIE = 1e-5
ATOL = 1e-5
BATCH = 32
JOIN_S = 120


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=JOIN_S)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _load(data):
    return np.load(io.BytesIO(data))


def _start(service, make):
    srv = make(service, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _model(num_quantizers=1, seed=0):
    """The JAX package's serving-test model (reference arch, D=32, K=64),
    drawn by the port's initialiser from a seeded generator: (JAX params,
    JAX config, the JAX-layout numpy tree, the port's config)."""
    kw = dict(embedding_dim=32, num_embeddings=64, num_quantizers=num_quantizers)
    cfg = ModelConfig(**kw)
    tree = params_to_jax(init_vqvae_params(torch.Generator().manual_seed(seed), cfg))
    jt = jax.tree.map(jnp.asarray, tree)
    jparams = VQVAEParams(encoder=jt["encoder"], decoder=jt["decoder"], vq=VQState(**jt["vq"]))
    return jparams, JaxModelConfig(**kw), tree, cfg


class _Pair:
    """A JAX and a port service of the same model, each behind a live
    server on an ephemeral port."""

    def __init__(self, num_quantizers=1, seed=0, batch=BATCH):
        self.jparams, self.jcfg, tree, self.cfg = _model(num_quantizers, seed)
        self.jcodec = JaxCodec(self.jparams, self.jcfg,
                               JaxCodecConfig(batch_size=batch, compute_dtype="float32"))
        self.codec = VQCodec(tree, self.cfg, CodecConfig(batch_size=batch,
                                                         compute_dtype="float32"),
                             device="cpu")
        self.jservice, self.service = JaxService(self.jcodec), CodecService(self.codec)
        self.jsrv = _start(self.jservice, jax_make_server)
        self.srv = _start(self.service, make_server)
        self.jaddr, self.addr = self.jsrv.server_address, self.srv.server_address

    def close(self):
        for srv in (self.srv, self.jsrv):
            srv.shutdown()
            srv.server_close()
        self.service.close()

    def scores(self, leaves):
        """JAX nearest-code scores [N, K] of the leaves' latents."""
        x = jnp.asarray(leaves.reshape(leaves.shape[:4] + (-1,)))
        z = np.asarray(jax_encoder_apply(self.jparams.encoder, x, self.jcfg))
        z = z.reshape(-1, self.jcfg.embedding_dim)
        e = np.asarray(self.jparams.vq.embedding)
        return (e * e).sum(1)[None] - 2.0 * z @ e.T


def _near_ties(scores):
    two = np.sort(scores, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))


def _assert_indices_match(got, want, scores):
    bad = got.reshape(-1) != want.reshape(-1)
    off = bad & ~_near_ties(scores)
    assert not off.any(), f"{int(off.sum())} rows differ off near-ties"


@pytest.fixture(scope="module")
def pair():
    p = _Pair()
    yield p
    p.close()


def _concurrent(fn, args, barrier=True):
    """fn(*a) for each a in args, one thread each, started together."""
    results = [None] * len(args)
    errors = []
    gate = threading.Barrier(len(args)) if barrier else None

    def run(i):
        try:
            if gate is not None:
                gate.wait(JOIN_S)
            results[i] = fn(*args[i])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client did not finish"
    assert not errors, errors
    return results


def test_healthz_and_stats_match_jax(pair):
    (s1, a), (s2, b) = _request(pair.addr, "GET", "/healthz"), _request(pair.jaddr, "GET", "/healthz")
    assert s1 == s2 == 200 and json.loads(a) == json.loads(b)
    _request(pair.addr, "POST", "/encode_leaves", _npy(np.zeros((2, 8, 8, 8), np.float32)))
    ours = json.loads(_request(pair.addr, "GET", "/stats")[1])
    theirs = json.loads(_request(pair.jaddr, "GET", "/stats")[1])
    assert ours.keys() == theirs.keys()
    assert ours["counters"].keys() == theirs["counters"].keys()
    assert ours["microbatch"].keys() == theirs["microbatch"].keys()
    assert ours["profile"]["device/dispatch"]["count"] >= 1


def test_leaf_endpoints_match_jax(pair):
    rng = np.random.default_rng(0)
    chunks = [rng.random((int(n), 8, 8, 8), np.float32) for n in rng.integers(3, 10, 8)]

    def encode(chunk):
        status, data = _request(pair.addr, "POST", "/encode_leaves", _npy(chunk))
        assert status == 200, data
        return _load(data)

    got = _concurrent(encode, [(c,) for c in chunks])
    scores = pair.scores(np.concatenate(chunks)[..., None])
    rows = np.cumsum([0] + [64 * c.shape[0] for c in chunks])
    for i, (chunk, idx) in enumerate(zip(chunks, got)):
        assert idx.shape == (chunk.shape[0], 4, 4, 4) and idx.dtype == np.uint8
        np.testing.assert_array_equal(idx, pair.codec.encode_leaves(chunk))
        status, data = _request(pair.jaddr, "POST", "/encode_leaves", _npy(chunk))
        assert status == 200
        want = _load(data)
        _assert_indices_match(idx, want, scores[rows[i]:rows[i + 1]])

        # Decode the JAX service's indices on both sides.
        status, data = _request(pair.addr, "POST", "/decode_indices", _npy(want))
        assert status == 200
        leaves = _load(data)
        np.testing.assert_array_equal(leaves, pair.codec.decode_indices(want))
        status, data = _request(pair.jaddr, "POST", "/decode_indices", _npy(want))
        np.testing.assert_allclose(leaves, _load(data), atol=ATOL, rtol=0)
        assert leaves.shape == (chunk.shape[0], 8, 8, 8, 1)


def test_malformed_request_is_isolated(pair):
    """A wrong channel count gets the JAX service's 400 while concurrent good
    requests get their own rows."""
    rng = np.random.default_rng(1)
    good = [rng.random((5, 8, 8, 8, 1), np.float32) for _ in range(6)]
    bad = rng.random((2, 8, 8, 8, 3), np.float32)
    bodies = [_npy(g) for g in good] + [_npy(bad)]
    answers = _concurrent(lambda b: _request(pair.addr, "POST", "/encode_leaves", b),
                          [(b,) for b in bodies])
    for g, (status, data) in zip(good, answers):
        assert status == 200
        np.testing.assert_array_equal(_load(data), pair.codec.encode_leaves(g))
    status, data = answers[-1]
    jstatus, jdata = _request(pair.jaddr, "POST", "/encode_leaves", bodies[-1])
    assert status == jstatus == 400
    assert json.loads(data) == json.loads(jdata)
    assert "expected leaves" in json.loads(data)["error"]


def test_errors_match_jax(pair):
    """404 on unknown paths, 400 on a body that is no .vqvdb file or a wrong
    index shape, 413 over the body limit: the JAX service's codes, JSON and
    error counts (a 404 counts none)."""
    def errors():
        return [json.loads(_request(a, "GET", "/stats")[1])["counters"]["errors"]
                for a in (pair.addr, pair.jaddr)]

    before = errors()
    for method, path, body in (("GET", "/nope", None), ("POST", "/nope", b"x"),
                               ("POST", "/decode_indices",
                                _npy(np.zeros((2, 4, 4), np.uint8)))):
        (s1, a), (s2, b) = (_request(pair.addr, method, path, body),
                            _request(pair.jaddr, method, path, body))
        assert s1 == s2 and s1 in (400, 404) and json.loads(a) == json.loads(b)
    s1, a = _request(pair.addr, "POST", "/decode", b"not a vqvdb file")
    s2, _ = _request(pair.jaddr, "POST", "/decode", b"not a vqvdb file")
    assert s1 == s2 == 400 and "error" in json.loads(a)
    limits = pair.service.max_body_bytes, pair.jservice.max_body_bytes
    pair.service.max_body_bytes = pair.jservice.max_body_bytes = 1024
    try:
        body = _npy(np.zeros((1, 8, 8, 8), np.float32))  # 2,176 B
        (s1, a), (s2, b) = (_request(pair.addr, "POST", "/encode_leaves", body),
                            _request(pair.jaddr, "POST", "/encode_leaves", body))
    finally:
        pair.service.max_body_bytes, pair.jservice.max_body_bytes = limits
    assert s1 == s2 == 413 and json.loads(a) == json.loads(b)
    assert [a - b for a, b in zip(errors(), before)] == [3, 3]


def test_sixteen_concurrent_clients_coalesce(pair):
    """16 clients at once, the interpreter switching threads every 10 us:
    every request is counted once, steps + coalesced account for each
    request, and some requests share a step."""
    rng = np.random.default_rng(2)
    chunks = [rng.random((3, 8, 8, 8), np.float32) for _ in range(16)]
    before = json.loads(_request(pair.addr, "GET", "/stats")[1])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        answers = _concurrent(lambda b: _request(pair.addr, "POST", "/encode_leaves", b),
                              [(_npy(c),) for c in chunks])
    finally:
        sys.setswitchinterval(interval)
    for c, (status, data) in zip(chunks, answers):
        assert status == 200
        np.testing.assert_array_equal(_load(data), pair.codec.encode_leaves(c))
    after = json.loads(_request(pair.addr, "GET", "/stats")[1])
    mb0, mb1 = before["microbatch"]["encode"], after["microbatch"]["encode"]
    steps, coalesced = mb1["steps"] - mb0["steps"], mb1["coalesced"] - mb0["coalesced"]
    assert after["counters"]["encode_leaves"] - before["counters"]["encode_leaves"] == 16
    assert steps + coalesced == 16 and coalesced >= 1 and steps < 16


def test_file_endpoints_match_jax(pair, tmp_path):
    """/encode of a dense volume and of a leaf array: the port's bytes are
    its codec's compress of the service's grid; the JAX service's file has
    the same length and differs only in near-tie index bytes. /decode of the
    JAX file: the same arrays, leaves within ATOL."""
    dense = smoke_volume(24, seed=3)
    leaves = np.random.default_rng(4).random((11, 8, 8, 8), np.float32)
    for arr in (dense, leaves):
        body = _npy(arr)
        status, ours = _request(pair.addr, "POST", "/encode?name=density", body)
        jstatus, theirs = _request(pair.jaddr, "POST", "/encode?name=density", body)
        assert status == jstatus == 200 and ours[:5] == b"VQVDB"
        grid = pair.service.grid_of_npy(body, "density")
        pair.codec.compress(grid, tmp_path / "direct.vqvdb")
        assert ours == (tmp_path / "direct.vqvdb").read_bytes()
        assert len(ours) == len(theirs)
        (tmp_path / "ours.vqvdb").write_bytes(ours)
        (tmp_path / "theirs.vqvdb").write_bytes(theirs)
        with VqvdbReader(tmp_path / "ours.vqvdb") as r:
            idx, org = r.read_grid()[1:]
        with VqvdbReader(tmp_path / "theirs.vqvdb") as r:
            jidx, jorg = r.read_grid()[1:]
        np.testing.assert_array_equal(org, jorg)
        _assert_indices_match(idx, jidx, pair.scores(grid.leaves))

        status, npz = _request(pair.addr, "POST", "/decode", theirs)
        jstatus, jnpz = _request(pair.jaddr, "POST", "/decode", theirs)
        assert status == jstatus == 200
        a, b = _load(npz), _load(jnpz)
        assert sorted(a.files) == sorted(b.files) == ["density_leaves", "density_origins"]
        np.testing.assert_array_equal(a["density_origins"], b["density_origins"])
        np.testing.assert_allclose(a["density_leaves"], b["density_leaves"], atol=ATOL, rtol=0)
    counters = json.loads(_request(pair.addr, "GET", "/stats")[1])["counters"]
    assert counters["encode"] >= 2 and counters["decode"] >= 2


def test_residual_vq_service_matches_jax():
    """(N,4,4,4,2) indices over /encode_leaves and /decode_indices; a
    single-stage index shape gets the JAX service's 400."""
    p = _Pair(num_quantizers=2, seed=1, batch=16)
    try:
        leaves = np.random.default_rng(2).random((5, 8, 8, 8), np.float32)
        status, data = _request(p.addr, "POST", "/encode_leaves", _npy(leaves))
        assert status == 200, data
        idx = _load(data)
        assert idx.shape == (5, 4, 4, 4, 2) and idx.dtype == np.uint8
        want = _load(_request(p.jaddr, "POST", "/encode_leaves", _npy(leaves))[1])
        # Stage by stage: a row may first differ only at a near-tie of that
        # stage's JAX scores; its later stages code another residual.
        e = np.asarray(p.jparams.vq.embedding)
        res = np.asarray(jax_encoder_apply(p.jparams.encoder, jnp.asarray(leaves[..., None]),
                                           p.jcfg)).reshape(-1, 32)
        same = np.ones(res.shape[0], bool)
        for s in range(2):
            scores = (e[s] * e[s]).sum(1)[None] - 2.0 * res @ e[s].T
            g, w = idx[..., s].reshape(-1), want[..., s].reshape(-1)
            assert not (same & (g != w) & ~_near_ties(scores)).any()
            same &= g == w
            res = res - e[s][w]

        status, data = _request(p.addr, "POST", "/decode_indices", _npy(want))
        assert status == 200
        jdata = _request(p.jaddr, "POST", "/decode_indices", _npy(want))[1]
        np.testing.assert_allclose(_load(data), _load(jdata), atol=ATOL, rtol=0)
        body = _npy(want[..., 0])
        (s1, a), (s2, b) = _request(p.addr, "POST", "/decode_indices", body), \
            _request(p.jaddr, "POST", "/decode_indices", body)
        assert s1 == s2 == 400 and json.loads(a) == json.loads(b)
    finally:
        p.close()


# ---------------------------------------------------------------------------
# Stage profiler
# ---------------------------------------------------------------------------

def test_profiler_accumulates():
    import time

    p = Profiler()
    for _ in range(3):
        with p("stage_a"):
            time.sleep(0.002)
    with p("stage_b"):
        pass
    rep = p.report()
    assert rep["stage_a"]["count"] == 3 and rep["stage_a"]["total_s"] >= 0.006
    assert rep["stage_a"]["mean_ms"] == pytest.approx(1e3 * rep["stage_a"]["total_s"] / 3)
    assert rep["stage_b"]["count"] == 1 and list(rep) == ["stage_a", "stage_b"]
    p.reset()
    assert p.report() == {}


def test_codec_profiler_reports_the_jax_stages(pair):
    """20 leaves at batch 8: three dispatches, one padded tail, as the JAX
    codec counts them, and the port's own stages (its construction's once,
    the staging copy and the readback wait once a batch); a shared profiler
    aggregates across calls."""
    rng = np.random.default_rng(0)
    leaves = rng.random((20, 8, 8, 8), np.float32)
    jcodec = JaxCodec(pair.jparams, pair.jcfg, JaxCodecConfig(batch_size=8,
                                                              compute_dtype="float32"))
    jcodec.encode_leaves(leaves)
    prof = Profiler()
    codec = VQCodec(jax.tree.map(np.asarray, pair.jparams._asdict()), pair.cfg,
                    CodecConfig(batch_size=8, compute_dtype="float32"), device="cpu",
                    profiler=prof)
    assert codec.profiler is prof
    codec.encode_leaves(leaves)
    ours, theirs = prof.report(), jcodec.profiler.report()
    assert theirs.keys() == {"device/dispatch", "host/pad"}
    for k in theirs:
        assert ours[k]["count"] == theirs[k]["count"]
    assert {k: v["count"] for k, v in ours.items()} == {
        "device/dispatch": 3, "host/pad": 1, "host/stage_in": 3, "device/readback_wait": 3,
        "init/weights": 1, "init/tail_fold": 1, "init/score_operand": 1, "init/down_fold": 1}
    codec.decode_indices(codec.encode_leaves(leaves[:16]))
    rep = prof.report()
    assert rep["device/dispatch"]["count"] == 7 and rep["host/pad"]["count"] == 1
    assert rep["host/stage_in"]["count"] == rep["device/readback_wait"]["count"] == 7
