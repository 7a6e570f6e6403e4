"""The decoder's head as one kernel (`ops/decoder_head.py`,
`csrc/decoder_head.cu`), without a card.

On the CPU the head runs its plain version, which is the eager
`blocks.channel_attention` and `apply_decoder_tail` bit for bit, for every
committed artifact's decoder in f32 and bf16, and the codec's decode step
(trunk, then the head) gives the plain graph's bits. A CPU head holds the
f32 fold and no operator tiles. The kernel's operand
layout is emulated from the kernel's own addressing rules: the operator
tiles, read the way the wgmma descriptors and a thread's A fragments read
them, give back the bf16 operator; a 32-deep chunk's gates are the channels
of its depths; the two rows of a quarter warp sit on disjoint banks. The
wrapper refuses the shapes the kernel does not take, on either device. The
kernel itself is held to the plain version on the card in
tests/test_torch_port_cuda.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vqvdb_tpu_torch.core.artifact import load_model
from vqvdb_tpu_torch.core.config import CodecConfig, ModelConfig
from vqvdb_tpu_torch.core.weights import params_from_jax
from vqvdb_tpu_torch.models import blocks, vqvae
from vqvdb_tpu_torch.models.quantizer import dequantize
from vqvdb_tpu_torch.ops import decoder_head as dh
from vqvdb_tpu_torch.ops.tail import apply_decoder_tail, fold_decoder_tail
from vqvdb_tpu_torch.runtime.codec import VQCodec

torch.set_num_threads(2)

MODELS = Path(__file__).resolve().parent.parent / "models"
ARTIFACTS = sorted(p.stem for p in MODELS.glob("*.vqmodel"))
LEAVES = 5
ODD_OFFSET = 64 * 128 + 64  # csrc/decoder_head.cu: kOddOffset
ROW_BYTES = 128


@pytest.fixture(scope="module", params=ARTIFACTS)
def model(request):
    tree, cfg = load_model(MODELS / f"{request.param}.vqmodel")
    return tree, params_from_jax(tree, cfg, "cpu"), cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_head_is_the_eager_attention_and_tail(model, dtype):
    """Every artifact's head, as the codec's step calls it, gives the eager
    `channel_attention` then `apply_decoder_tail` bit for bit, and the
    unfolded tail (`decoder_tail`) within f32 rounding in f32. The head
    holds the f32 fold, which the plain version reads, and no tiles."""
    _, params, cfg = model
    dec = params["decoder"]
    head = dh.prepare_head(dec, cfg, dtype)
    c = dec["attn"]["fc1"]["w"].shape[0]
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (LEAVES, 4, 4, 4, c)).astype(np.float32)).to(dtype)
    with torch.inference_mode():
        got = dh.decoder_head_fused(head, h, cfg)
        gated = blocks.channel_attention(dec["attn"], h)
        want = apply_decoder_tail(fold_decoder_tail(dec, cfg), gated, cfg)
        assert got.shape == (LEAVES, 8, 8, 8, cfg.in_channels) and got.dtype == torch.float32
        assert torch.equal(got, want)
        if dtype == torch.float32:
            torch.testing.assert_close(got, vqvae.decoder_tail(dec, gated, cfg),
                                       atol=5e-5, rtol=0)
    assert sorted(head) == ["b", "k", "w1", "w2"]
    assert torch.equal(head["k"], fold_decoder_tail(dec, cfg)["k"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_codec_decode_step_is_the_trunk_then_the_head(model, dtype):
    """The codec's decode step on the CPU: the dequantized rows through
    `decoder_trunk`, then the head, equal to the plain graph
    (`decoder_tail(decoder_pre_tail(...))` with the tail folded) bit for bit."""
    tree, _, cfg = model
    codec = VQCodec(tree, cfg, CodecConfig(batch_size=LEAVES, compute_dtype=dtype),
                    device="cpu")
    s = cfg.num_quantizers
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.num_embeddings, (LEAVES,) + cfg.index_shape)).to(torch.int32)
    books = codec._codebook.reshape(s, cfg.num_embeddings, cfg.embedding_dim)
    with torch.inference_mode():
        z = sum(dequantize(idx.reshape(-1, s)[:, j], books[j]) for j in range(s))
        z = z.reshape((LEAVES,) + cfg.latent_shape + (cfg.embedding_dim,))
        dec = codec.params["decoder"]
        want = apply_decoder_tail(fold_decoder_tail(dec, cfg),
                                  vqvae.decoder_pre_tail(dec, z, cfg), cfg)
        got = codec._decode_step(idx)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,c_out", [(64, 1), (128, 3), (128, 1), (64, 3)])
def test_operator_tiles_read_as_the_kernel_reads_them(c, c_out):
    """Rebuild the operator from its tiles by the kernel's rules: stage s,
    chunk d, step u of a 32-deep chunk; thread t's 8 values of a row at
    depths 64 s + 32 d + 8 t + e; A fragment word pairs (w[2u], w[2u + 1])
    as MMA depths (2t + x, 2t + 8 + x) = values (4u + x, 4u + 2 + x); B
    core matrix (column tile, stage, step, column group, half, column,
    depth) with LBO between the halves and SBO between groups. The result is
    the bf16 operator."""
    depth, n_out = 64 * c, 512 * c_out
    k = torch.from_numpy(np.random.default_rng(c + c_out).standard_normal(
        (depth, n_out)).astype(np.float32))
    bn = dh.head_plan(n_out)
    op = dh.operator_tiles(k)
    assert op.shape == (n_out // bn, depth // 64, 4, bn // 8, 2, 8, 8) and op.is_contiguous()
    flat = op.reshape(-1)
    group_bytes, half_bytes = 256, 128  # SBO, LBO of csrc/decoder_head.cu
    step_bytes = bn * 32
    got = torch.empty((depth, n_out), dtype=torch.bfloat16)
    cols = torch.arange(n_out)
    tile, col = cols // bn, cols % bn
    for q in range(depth // 16):
        s, d, u = q // 4, (q // 2) % 2, q % 2
        for t in range(4):
            for x in range(2):
                for half in range(2):
                    mma_depth = 2 * t + x  # within the half
                    real = 64 * s + 32 * d + 8 * t + 4 * u + 2 * half + x
                    byte = ((tile * (depth // 64) + s) * 4 * step_bytes + (q % 4) * step_bytes
                            + (col // 8) * group_bytes + half * half_bytes + (col % 8) * 16
                            + mma_depth * 2)
                    got[real] = flat[byte // 2]
    assert torch.equal(got, k.to(torch.bfloat16))


@pytest.mark.parametrize("g", [2, 4])
def test_a_chunks_gates_and_banks(g):
    """Chunk (s, d) of a row of C = 32 g channels covers 32 contiguous depths
    of one position, whose channels start at 32 ((2 s + d) mod g); and in a
    stage the eight lanes of each quarter warp read two rows (g even and
    odd) of 64 bytes on disjoint 4-byte banks."""
    c = 32 * g
    for s in range(2 * g + 1):
        for d in range(2):
            for t in range(4):
                for e in range(8):
                    depth = 64 * s + 32 * d + 8 * t + e
                    assert depth % c == 32 * ((2 * s + d) % g) + 8 * t + e
    for wg in range(2):
        for warp in range(4):
            for quarter in range(4):
                for d in range(2):
                    banks = []
                    for lane in range(8 * quarter, 8 * quarter + 8):
                        gg, t = lane >> 2, lane & 3
                        row = 64 * wg + 16 * warp + gg
                        for r in range(2):
                            off = ((gg & 1) * ODD_OFFSET + (row >> 1) * ROW_BYTES
                                   + 4 * r * ROW_BYTES + 16 * t + 64 * d)
                            banks.append({(off // 4 + i) % 32 for i in range(4)})
                    for r in range(2):  # one 16-byte load per row pair at a time
                        seen = [b for i, b in enumerate(banks) if i % 2 == r]
                        assert len(set().union(*seen)) == 32, (wg, warp, quarter, d, r)


def test_head_plan_reads_the_outputs_alone():
    assert [dh.head_plan(n) for n in (512, 1024, 1536, 3072)] == [128, 128, 192, 192]
    with pytest.raises(ValueError, match="multiple of 128"):
        dh.head_plan(640 + 64)


def _small_head(c=64, c_out=1, hid=None):
    hid = hid or c // 4
    k = torch.randn(64 * c, 512 * c_out)
    return {"k": k, "b": torch.zeros(512 * c_out),
            "w1": torch.randn(c, hid), "w2": torch.randn(hid, c)}, ModelConfig(in_channels=c_out)


@pytest.mark.parametrize("case", ["f16", "width48", "width32", "strided", "shape", "hidden",
                                  "channels", "weights64"])
def test_head_refuses_what_the_kernel_cannot_take(case):
    """The wrapper's checks of the features and weights are the kernel's,
    on the CPU too: a bf16 or f32 dense (B, 4, 4, 4, C_in) with C_in 64 or
    128 (every shipped decoder's), dense f32 attention weights that fit it,
    and a bias of 8^3 x C_out."""
    c = {"width48": 48, "width32": 32}.get(case, 64)
    head, cfg = _small_head(c=c, hid=2 * c if case == "hidden" else None)
    h = torch.randn(3, 4, 4, 4, c).to(torch.bfloat16)
    if case == "f16":
        h = h.half()
    elif case == "strided":
        h = torch.randn(3, 4, 4, 4, 2 * c).to(torch.bfloat16)[..., ::2]
    elif case == "shape":
        h = h.reshape(3, 8, 2, 4, c)
    elif case == "channels":
        cfg = ModelConfig(in_channels=3)
    elif case == "weights64":
        head["w1"] = head["w1"].double()
    with pytest.raises(ValueError):
        dh.decoder_head_fused(head, h, cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_head_on_the_cpu_is_the_plain_version(dtype):
    """On the CPU the wrapper returns the plain version for f32 and bf16
    features alike and launches nothing."""
    head, cfg = _small_head()
    h = torch.randn(3, 4, 4, 4, 64).to(dtype)
    launches = dh.decoder_head_fused.launches
    with torch.inference_mode():
        assert torch.equal(dh.decoder_head_fused(head, h, cfg),
                           dh.decoder_head_plain(head, h, cfg))
    assert dh.decoder_head_fused.launches == launches


@pytest.mark.parametrize("in_channels,name", [(1, "sigmoid"), (3, "tanh")])
def test_the_kernels_activation_is_the_models(in_channels, name):
    """The wrapper's `act` code names the activation `head_activation`
    applies: 0 sigmoid for scalar fields, 1 tanh for vec3 ones."""
    cfg = ModelConfig(in_channels=in_channels)
    assert vqvae.head_activation_name(cfg) == name
    assert dh.ACTIVATIONS.index(name) == (in_channels != 1)
    x = torch.linspace(-4, 4, 9)
    assert torch.equal(vqvae.head_activation(x, cfg), getattr(torch, name)(x))
