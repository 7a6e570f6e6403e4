"""GroupNorm + affine + ReLU as one kernel (`ops/group_norm.py`,
`csrc/group_norm.cu`), without a card.

The plain version is the eager `torch.relu(blocks.group_norm(...))` bit for
bit; a numpy emulation of the kernel's fixed reduction order (each thread's
values in order, then for each leaf and group one warp's lanes in order and
an xor butterfly over the lanes) stays within 2e-6 of an
f64 GroupNorm (relative to max(|value|, 1): the outputs are normalised, so a
value near 0 carries the error of the group's mean), and gives a leaf the
same bits alone and among 63 others. The dispatch in `models/blocks.py`
keeps the eager form on the CPU and in training, every GroupNorm of every
committed model's inference graphs goes through it, and the kernel takes
each shape they reach. The kernel itself is held to the plain version on
the card in tests/test_torch_port_cuda.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig
from vqvdb_tpu_torch.models import blocks, vqvae
from vqvdb_tpu_torch.ops import fused_rb
from vqvdb_tpu_torch.ops import group_norm as gn
from vqvdb_tpu_torch.runtime.codec import VQCodec

torch.set_num_threads(2)

MODELS = Path(__file__).resolve().parent.parent / "models"
# (voxels, channels, groups) the committed models reach, packed_stem's 8^3
# stage (8 or 16 channels in half as many groups), and `chip_smoke.py`'s
# derived model of encoder width 160 (groups of 20 channels).
SHAPES = [(512, 64, 8), (64, 128, 8), (64, 64, 8), (512, 16, 4), (512, 8, 4),
          (512, 16, 8), (64, 32, 8), (64, 160, 8)]
EPS = 1e-5


def _spatial(s):
    return (8, 8, 8) if s == 512 else (4, 4, 4)


def _inputs(rng, b, s, c, dtype=torch.float32):
    """Conv-output-like leaves (a per-channel offset and spread) and
    trained-looking affine params."""
    x = (rng.standard_normal((b, s, c)) * rng.uniform(0.5, 2.0, c)
         + rng.uniform(-0.5, 0.5, c)).astype(np.float32)
    params = {"scale": torch.from_numpy((1 + 0.2 * rng.standard_normal(c)).astype(np.float32)),
              "bias": torch.from_numpy((0.2 * rng.standard_normal(c)).astype(np.float32))}
    return torch.from_numpy(x).reshape((b,) + _spatial(s) + (c,)).to(dtype), params


def emulate(x: np.ndarray, scale, bias, groups: int, eps: float = EPS) -> np.ndarray:
    """The kernel's arithmetic in numpy f32: x [B, S, C] f32 -> relu(GN(x))
    [B, S, C], each sum in the kernel's order under its plan: a thread's
    values in order, then per (leaf, group) lane j of a warp adding members
    j, j + 32, ... in order and an xor butterfly over the 32 lanes."""
    b, s, c = x.shape
    plan = gn.group_norm_plan(s, c, groups, 4)
    vv, gv = c // plan.ve, c // groups // plan.ve
    members = plan.team // groups
    # vector u + k * team of a leaf is thread u's k-th: [leaf, k, u, e]
    r = x.reshape(b, plan.v, plan.team, plan.ve)
    lanes = np.arange(32)

    def group_totals(vals):  # [leaf, k, u, e] -> [leaf, groups]
        t = np.zeros((b, plan.team), np.float32)
        for k in range(plan.v):
            for e in range(plan.ve):
                t = t + vals[:, k, :, e]
        totals = []
        for g in range(groups):
            i = np.arange(members)
            thread = (i // gv) * vv + g * gv + i % gv
            w = np.zeros((b, 32), np.float32)
            for start in range(0, members, 32):
                part = t[:, thread[start:start + 32]]
                w[:, :part.shape[1]] = w[:, :part.shape[1]] + part
            for off in (1, 2, 4, 8, 16):
                w = w + w[:, lanes ^ off]
            totals.append(w[:, 0])
        return np.stack(totals, axis=1)

    inv_n = np.float32(1.0 / (s * (c // groups)))
    group_of = (np.arange(plan.team) % vv) // gv  # each thread's group
    mean = (group_totals(r) * inv_n)[:, group_of][:, None, :, None]
    d = r - mean
    var = group_totals(d * d) * inv_n
    rstd = (1.0 / np.sqrt((var + np.float32(eps)).astype(np.float64))).astype(np.float32)
    y = d * rstd[:, group_of][:, None, :, None]
    ch = (np.arange(plan.team) % vv)[:, None] * plan.ve + np.arange(plan.ve)  # [u, e]
    y = y * scale[ch] + bias[ch]
    y = np.where(y < 0, np.float32(0), y)
    return y.reshape(b, s, c)


def _f64_reference(x, scale, bias, groups, eps=EPS):
    b, s, c = x.shape
    g = x.astype(np.float64).reshape(b, s, groups, c // groups)
    mean = g.mean(axis=(1, 3), keepdims=True)
    var = ((g - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    y = ((g - mean) / np.sqrt(var + eps)).reshape(b, s, c) * scale + bias
    return np.maximum(y, 0)


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,c,groups", SHAPES)
def test_plain_is_the_eager_group_norm_and_relu(rng, s, c, groups, dtype, b):
    x, params = _inputs(rng, b, s, c, dtype)
    want = torch.relu(blocks.group_norm(params, x, groups))
    got = gn.group_norm_relu_plain(params, x, groups)
    assert got.dtype == dtype and torch.equal(got, want)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    launches = gn.group_norm_relu_fused.launches
    assert torch.equal(gn.group_norm_relu_fused(params, x, groups), want)
    assert gn.group_norm_relu_fused.launches == launches


@pytest.mark.parametrize("s,c,groups", SHAPES)
def test_emulated_kernel_order_is_near_f64_and_batch_invariant(rng, s, c, groups):
    x, params = _inputs(rng, 64, s, c)
    xs = x.reshape(64, s, c).numpy()
    scale, bias = params["scale"].numpy(), params["bias"].numpy()
    got = emulate(xs, scale, bias, groups)
    ref = _f64_reference(xs, scale, bias, groups)
    assert np.all(np.abs(got - ref) <= 2e-6 * np.maximum(np.abs(ref), 1.0))
    for i in (0, 37, 63):
        alone = emulate(xs[i:i + 1], scale, bias, groups)
        assert alone.tobytes() == got[i:i + 1].tobytes()
    # and it differs from the eager version only by the order of its sums
    plain = gn.group_norm_relu_plain(params, x, groups).reshape(64, s, c).numpy()
    assert np.all(np.abs(got - plain) <= 2e-6 * np.maximum(np.abs(plain), 1.0))


def test_dispatch_keeps_the_eager_form_on_the_cpu_and_in_training(rng, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(gn, "group_norm_relu_fused", refuse)
    x, params = _inputs(rng, 5, 64, 64)
    want = torch.relu(blocks.group_norm(params, x, 8))
    with torch.inference_mode():
        assert torch.equal(blocks.group_norm_relu(params, x, 8), want)
    leaf = x.clone().requires_grad_(True)
    got = blocks.group_norm_relu(params, leaf, 8)
    assert torch.equal(got.detach(), want)
    got.sum().backward()
    ref_leaf = x.clone().requires_grad_(True)
    torch.relu(blocks.group_norm(params, ref_leaf, 8)).sum().backward()
    assert torch.equal(leaf.grad, ref_leaf.grad)


@pytest.mark.parametrize("case,message", [
    ("non_contiguous", "dense channels-last"),
    ("int32", "float32 or bfloat16"),
    ("float16", "float32 or bfloat16"),
    ("groups_do_not_divide", "must divide"),
    ("leaf_too_large", "too large"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(rng, case, message):
    x, params = _inputs(rng, 2, 64, 64)
    groups = 8
    if case == "non_contiguous":
        x = x.transpose(1, 2)
    elif case in ("int32", "float16"):
        x = x.to(getattr(torch, case))
    elif case == "groups_do_not_divide":
        groups = 6
    else:  # 4^3 x 4096 f32: 1,024 vectors a voxel, 64 a thread, past 512 threads
        x, params = _inputs(rng, 1, 64, 4096)
    with pytest.raises(ValueError, match=message):
        gn.group_norm_relu_fused(params, x, groups)


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("s,c,groups", SHAPES)
def test_plan_stages_the_leaves_of_every_shape_the_models_reach(s, c, groups, elem_bytes):
    plan = gn.group_norm_plan(s, c, groups, elem_bytes)
    assert plan.staged
    assert plan.leaves * s * c * elem_bytes <= gn.MAX_TILE_BYTES


def test_plan_reads_a_leaf_too_large_for_shared_memory_in_each_pass():
    """4^3 x 1,024 in f32: 256 KB a leaf, one leaf a block, not staged."""
    plan = gn.group_norm_plan(64, 1024, 8, 4)
    assert (plan.leaves, plan.staged, plan.team) == (1, False, 512)
    assert gn.group_norm_plan(64, 1024, 8, 2).staged  # the same leaf in bf16: 128 KB


def _gn_count(tree) -> int:
    """GroupNorm params ({"scale", "bias"}) in a params tree."""
    if not isinstance(tree, dict):
        return 0
    if set(tree) == {"scale", "bias"}:
        return 1
    return sum(_gn_count(v) for v in tree.values())


@pytest.mark.parametrize("name", sorted(p.stem for p in MODELS.glob("*.vqmodel")))
def test_every_group_norm_of_a_models_inference_graphs_reaches_the_dispatch(
        rng, monkeypatch, name):
    """The codec's encode and decode steps and the unfolded graphs
    (`encode_to_indices`, `decode_from_indices`) call GroupNorm only through
    `blocks.group_norm_relu` (but inside the fused 16-channel block, a
    kernel of its own on the card), once per GroupNorm of the graph, at
    shapes the kernel takes in bf16 and f32."""
    tree, cfg = load_model(MODELS / f"{name}.vqmodel")
    calls, stray = [], []
    state = {"inside": 0}
    group_norm, group_norm_relu = blocks.group_norm, blocks.group_norm_relu
    rb_plain = fused_rb.residual_block_plain

    def counted_relu(params, x, groups):
        calls.append((x[0, ..., 0].numel(), x.shape[-1], groups))
        state["inside"] += 1
        try:
            return group_norm_relu(params, x, groups)
        finally:
            state["inside"] -= 1

    def counted(params, x, groups, eps=1e-5):
        if not state["inside"]:
            stray.append(tuple(x.shape))
        return group_norm(params, x, groups, eps)

    def fused_plain(*args, **kwargs):
        state["inside"] += 1
        try:
            return rb_plain(*args, **kwargs)
        finally:
            state["inside"] -= 1

    monkeypatch.setattr(blocks, "group_norm_relu", counted_relu)
    monkeypatch.setattr(blocks, "group_norm", counted)
    monkeypatch.setattr(fused_rb, "residual_block_plain", fused_plain)
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=16), device="cpu")
    leaves = torch.from_numpy(rng.random((3, 8, 8, 8, cfg.in_channels), np.float32))
    enc_gn = _gn_count(codec.params["encoder"])
    dec_gn = _gn_count(codec.params["decoder"])
    fused = 2 if (cfg.encoder_arch == "reference" and cfg.variant == "scalar"
                  and cfg.num_quantizers == 1) else 0

    idx = codec._encode_step(leaves)
    assert len(calls) == enc_gn - fused
    codec._decode_step(idx)
    assert len(calls) == enc_gn - fused + dec_gn
    with torch.inference_mode():
        idx = vqvae.encode_to_indices(codec.params, leaves, cfg)
        vqvae.decode_from_indices(codec.params, idx, cfg)
    assert len(calls) == 2 * (enc_gn + dec_gn) - fused
    assert not stray, stray
    for s, c, groups in set(calls):
        for elem_bytes in (2, 4):
            gn.group_norm_plan(s, c, groups, elem_bytes)
