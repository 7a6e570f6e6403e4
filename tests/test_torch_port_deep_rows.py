"""Rows of any depth and codebook rows of any width, on the CPU.

The score kernel (`csrc/score_argmin_tc.cu`) takes rows too deep for two
full-depth row stages in its streamed-depth mode, and the dequantize
kernel (`csrc/dequantize.cu`) rows of any even byte width. What can be
checked without a card:

  * the plain versions against the Pallas kernels in interpret mode at
    depths 160 and 1024 (indices equal except rows whose best and runner-up
    JAX scores differ by less than NEAR_TIE = 1e-5 relative: f32 sums in
    another order; exactly on small integers), and the dequantize rows of
    bf16 D = 20 / 21 and f32 D = 5 bit for bit;
  * `score_plan`, the wrapper's copy of the kernel's shared-memory choice:
    which mode each shape takes, and that every shape the kernel took
    before keeps its mode and stages;
  * a numpy emulation of the streamed-depth ring: the producer's stages
    (B chunk, then 128 rows x 32 depths) and the consumers' mbarrier
    protocol, stepped in every order a scheduler picks, and the fragments
    and B tiles each consumer reads from a stage, which must be the chunk's
    rows and M's operand in the order `split_scores` sums them.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvdb_tpu.ops import quantize as jq
from vqvdb_tpu_torch.models.quantizer import dequantize, nearest_indices
from vqvdb_tpu_torch.ops import quantize as q

torch.set_num_threads(2)

NEAR_TIE = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert_equal_off_near_ties(got, ref, scores):
    two = np.sort(scores, axis=1)[:, :2]
    loose = (two[:, 1] - two[:, 0]) < NEAR_TIE * np.maximum(1.0, np.abs(two[:, 0]))
    bad = got != ref
    assert not (bad & ~loose).any(), f"{int((bad & ~loose).sum())} rows differ off near-ties"


@pytest.mark.parametrize("f,rows_dtype", [(160, "float32"), (1024, "float32"),
                                          (1024, "bfloat16")])
def test_deep_score_rows_match_pallas(rng, f, rows_dtype):
    n, k = 300, 256
    h, m, c = _rand(rng, n, f), _rand(rng, f, k) / np.sqrt(f), _rand(rng, 1, k)
    jh = jnp.asarray(h).astype(getattr(jnp, rows_dtype))
    ref = np.asarray(jq.fused_score_argmin(jh, jnp.asarray(m), jnp.asarray(c), tile_n=256,
                                           interpret=True))
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(getattr(torch, rows_dtype))
    scores = np.asarray(jh.astype(jnp.float32)).astype(np.float64) @ m + c
    for plain in (q.score_argmin_plain, q.score_argmin_split_plain):
        got = plain(th, torch.from_numpy(m), torch.from_numpy(c)).numpy()
        _assert_equal_off_near_ties(got, ref, scores)
    # small integers: every sum exact, a tie between codes 9 and 200
    hi = rng.integers(-3, 4, size=(n, f)).astype(np.float32)
    mi = rng.integers(-3, 4, size=(f, k)).astype(np.float32)
    ci = rng.integers(-40, 40, size=(1, k)).astype(np.float32)
    mi[:, 200] = mi[:, 9]
    ci[0, 9] = ci[0, 200] = -1e6
    ref = np.asarray(jq.fused_score_argmin(jnp.asarray(hi), jnp.asarray(mi), jnp.asarray(ci),
                                           tile_n=256, interpret=True))
    got = q.score_argmin_split_plain(torch.from_numpy(hi), torch.from_numpy(mi),
                                     torch.from_numpy(ci)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 9).all()


@pytest.mark.parametrize("d", [160, 1024])
def test_deep_nearest_matches_pallas(rng, d):
    n, k = 300, 256
    z, cb = _rand(rng, n, d), _rand(rng, k, d)
    ref = np.asarray(jq.fused_nearest_indices(jnp.asarray(z), jnp.asarray(cb), tile_n=256,
                                              interpret=True))
    scores = (cb.astype(np.float64) ** 2).sum(1)[None] - 2 * z.astype(np.float64) @ cb.T
    _assert_equal_off_near_ties(nearest_indices(torch.from_numpy(z), torch.from_numpy(cb))
                                .numpy(), ref, scores)
    prep = q.prepare_codebook(torch.from_numpy(cb))
    got = q.score_argmin_split_plain(torch.from_numpy(z), prep.m, prep.c).numpy()
    _assert_equal_off_near_ties(got, ref, scores)


@pytest.mark.parametrize("d,dtype", [(20, "bfloat16"), (21, "bfloat16"), (5, "float32")])
def test_narrow_codebook_rows_match_pallas(rng, d, dtype):
    k, n = 256, 700
    cb = jnp.asarray(_rand(rng, k, d)).astype(getattr(jnp, dtype))
    idx = rng.integers(0, k, size=n).astype(np.int32)
    idx[[0, 5, n - 1]] = [k, 300, -1]  # out of range: zero rows
    ref = np.asarray(jq.fused_dequantize(jnp.asarray(idx), cb, tile_n=256,
                                         interpret=True).astype(jnp.float32))
    tcb = torch.from_numpy(np.asarray(cb.astype(jnp.float32))).to(getattr(torch, dtype))
    got = q.fused_dequantize(torch.from_numpy(idx), tcb)
    assert got.dtype == tcb.dtype and got.shape == (n, d)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(dequantize(torch.from_numpy(idx), tcb).float().numpy(), ref)
    assert not ref[[0, 5, n - 1]].any()


# ---------------------------------------------------------------------------
# The shared-memory plan
# ---------------------------------------------------------------------------

def _plan_before(fp, kt, row_bytes):
    """The kernel's choice before the streamed-depth mode: resident, else a
    ring of B chunks beside two full-depth row stages, else refused."""
    chunk, rows = 192 * kt, 128 * fp * row_bytes
    fixed = 4 * kt + q.BARRIER_BYTES
    a = 4
    while a > 2 and fp // 32 * chunk + a * rows + fixed > q.SMEM_LIMIT:
        a -= 1
    if fp // 32 * chunk + a * rows + fixed <= q.SMEM_LIMIT:
        return ("resident", a, 0)
    if 2 * chunk + 2 * rows + fixed <= q.SMEM_LIMIT:
        return ("ring", 2, min(4, (q.SMEM_LIMIT - 2 * rows - fixed) // chunk))
    return None


@pytest.mark.parametrize("fp,kt,row_bytes,mode", [
    (32, 256, 2, "resident"), (64, 256, 2, "resident"), (128, 256, 2, "ring"),
    (64, 256, 4, "resident"), (128, 256, 4, "ring"), (256, 256, 2, "ring"),
    (160, 256, 4, "streamed"), (512, 256, 4, "streamed"), (1024, 256, 4, "streamed"),
    (320, 256, 2, "streamed"), (1024, 256, 2, "streamed"), (1024, 64, 4, "streamed"),
    (4096, 256, 4, "streamed")])
def test_score_plan_modes(fp, kt, row_bytes, mode):
    plan = q.score_plan(fp, kt, row_bytes)
    assert plan.mode == mode and plan.smem <= q.SMEM_LIMIT
    if mode == "streamed":
        assert plan.a_stages == 0 and 2 <= plan.b_stages <= q.MAX_B_STAGES
        stage = 192 * kt + 128 * 32 * row_bytes
        assert plan.smem == plan.b_stages * stage + 4 * kt + q.BARRIER_BYTES


def test_score_plan_keeps_every_earlier_shape():
    """Every (depth, tile, row type) the kernel took before keeps its mode
    and stages; only those it refused take the streamed depth, and no depth
    is refused now."""
    for fp, kt, row_bytes in itertools.product(range(32, 2049, 32), (64, 128, 192, 256), (2, 4)):
        plan, before = q.score_plan(fp, kt, row_bytes), _plan_before(fp, kt, row_bytes)
        assert plan is not None
        if before is None:
            assert plan.mode == "streamed"
        else:
            assert (plan.mode, plan.a_stages, plan.b_stages) == before


# ---------------------------------------------------------------------------
# The streamed-depth ring, emulated
# ---------------------------------------------------------------------------

class _Barrier:
    """An mbarrier: a phase completes when `count` arrivals came; wait(p)
    passes once the phase of parity p has completed (the kernel's
    mbar_wait: the current phase's parity differs from p)."""

    def __init__(self, count):
        self.count, self.arrived, self.phases = count, 0, 0

    def ready(self, parity):
        return self.phases % 2 != parity

    def arrive(self):
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.phases = 0, self.phases + 1


def _run_ring(pairs, nch, stages, order_seed):
    """Step the producer warp and the two consumer warpgroups of one block
    in a random interleaving; returns, per consumer, the (pair, chunk) it
    found in each stage it read, and the stage contents it read."""
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(2) for _ in range(stages)]  # one arrival per warpgroup here
    content = [None] * stages

    def producer():
        stage, parity = 0, 1
        for pair in range(pairs):
            for d in range(nch):
                while not empty[stage].ready(parity):
                    yield
                content[stage] = (pair, d)
                full[stage].arrive()
                stage, parity = (0, parity ^ 1) if stage + 1 == stages else (stage + 1, parity)
                yield

    seen = [[], []]

    def consumer(wg):
        take, parity, give = 0, 0, 0
        held = []

        def acquire():
            nonlocal take, parity
            while not full[take].ready(parity):
                yield
            held.append(take)
            seen[wg].append(content[take])
            take, parity = (0, parity ^ 1) if take + 1 == stages else (take + 1, parity)

        def give_back():
            nonlocal give
            assert held.pop(0) == give
            empty[give].arrive()
            give = 0 if give + 1 == stages else give + 1

        for _ in range(pairs):
            yield from acquire()
            for d in range(nch):
                yield  # the MMAs of chunk d start
                if d > 0:
                    give_back()  # chunk d - 1's MMAs are done
                if d + 1 < nch:
                    yield from acquire()
            give_back()
            yield

    actors = [producer(), consumer(0), consumer(1)]
    rng = np.random.default_rng(order_seed)
    alive = list(actors)
    steps = 0
    while alive:
        actor = alive[rng.integers(len(alive))]
        try:
            next(actor)
        except StopIteration:
            alive.remove(actor)
        steps += 1
        assert steps < 100000, "the ring deadlocked"
    return seen


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("nch", [1, 2, 5, 32])
def test_streamed_ring_protocol(stages, nch):
    """Whatever the interleaving, each consumer reads chunk 0 .. nch-1 of
    each pair in order, and the producer never refills a stage that a
    consumer still holds."""
    for seed in range(8):
        seen = _run_ring(pairs=3, nch=nch, stages=stages, order_seed=seed)
        want = [(p, d) for p in range(3) for d in range(nch)]
        assert seen == [want, want]


def _fragments_from_stage(a_stage, wg, u):
    """A [64, 16] of step u as warpgroup wg's threads load it from the
    stage: thread (warp w, lane g*4+t) reads 8 values of row 16w + g (and
    + 8) at element offset (wg * 64 + row) * 32 + 8 t; values 4u .. 4u+3
    become MMA depths 2t, 2t+1, 2t+8, 2t+9."""
    flat = a_stage.reshape(-1)
    out = np.zeros((64, 16), a_stage.dtype)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in (0, 8):
                row = 16 * w + g + r
                off = (wg * 64 + row) * 32 + 8 * t
                out[row, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = flat[off + 4 * u: off + 4 * u + 4]
    return out


@pytest.mark.parametrize("f,rows_dtype", [(160, "float32"), (96, "bfloat16")])
def test_streamed_stage_reads_give_the_split_scores(rng, f, rows_dtype):
    """Scores summed from what each consumer reads out of the ring stages
    (per chunk, the products in the kernel's order) equal the f64 products
    within f32 rounding, their argmin is `score_argmin_split_plain`'s off
    near-ties, and each fragment read from a stage is the one the
    full-depth layout gives."""
    kt = 128
    h = torch.from_numpy(_rand(rng, 128, f)).to(getattr(torch, rows_dtype))
    m, c = torch.from_numpy(_rand(rng, f, kt)), torch.from_numpy(_rand(rng, kt))
    prep = q.prepare_scores(m, c)
    fp = -(-f // 32) * 32
    padded = torch.nn.functional.pad(h.float(), (0, fp - f))
    if rows_dtype == "bfloat16":
        terms, products = [padded, None, None], q.PRODUCTS_BF16_ROWS
    else:
        terms, products = [t.float() for t in q.split_bf16(padded)], q.PRODUCTS_F32_ROWS
    terms.append(torch.where(torch.isfinite(terms[0]), terms[0], torch.zeros(())))
    terms = [None if t is None else t.numpy() for t in terms]
    flat = prep.operand.float().numpy().reshape(-1)
    chunk = 3 * 2 * 16 * kt
    acc = np.zeros((128, kt), np.float32)
    for d in range(fp // 32):
        # a stage as the producer fills it: chunk d of B, then the 128 rows'
        # depths 32 d .. 32 d + 31 ([warpgroup][64 rows][32], a copy a row)
        b = flat[d * chunk:(d + 1) * chunk]
        for wg in range(2):
            for ht, mt in products:
                a_stage = terms[ht][:, 32 * d:32 * d + 32]
                for u in range(2):
                    frag = _fragments_from_stage(a_stage, wg, u)
                    rows = terms[ht][64 * wg:64 * wg + 64]
                    want = np.zeros_like(frag)
                    for t in range(4):
                        x = rows[:, 32 * d + 8 * t + 4 * u:32 * d + 8 * t + 4 * u + 4]
                        want[:, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = x
                    np.testing.assert_array_equal(frag, want)
                    base = ((mt * 2) + u) * 16 * kt
                    kk, n = np.meshgrid(np.arange(16), np.arange(kt), indexing="ij")
                    btile = b[base + (n // 8) * 128 + (kk // 8) * 64 + (n % 8) * 8 + kk % 8]
                    acc[64 * wg:64 * wg + 64] += frag @ btile
    exact = h.double() @ m.double()
    scale = (h.double().abs() @ m.double().abs()).numpy()
    assert (np.abs(acc - exact.numpy()) <= 4e-7 * scale + 1e-30).all()
    got = np.argmin(acc + c.numpy()[None, :], axis=1)
    want = q.score_argmin_split_plain(h, m, c).numpy()
    _assert_equal_off_near_ties(got, want, (exact + c.double()).numpy())
