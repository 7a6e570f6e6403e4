"""Bytes and operations that the fused residual block of the reference
encoder's 8^3 stage needs (csrc/fused_rb_tc.cu, `rb16_tc_kernel`: RB(16),
x + 0.1 conv2(relu(gn2(conv1(relu(gn1(x)))))) over a leaf's 512 voxels).

The algorithm's work, not the kernel's split-bf16 products: two k3 convs of
C -> C channels over 512 voxels (2 * 512 * 27 C^2 operations each, at the
bf16 rate); each leaf's input read once and its output written once in the
compute dtype; per launch, the two convs' float32 weights (27 C^2 each) and
the six float32 rows of C (both GroupNorms' scale and bias, both biases).
"""

from __future__ import annotations

from typing import Tuple

from portbench.counts import flops

TAPS = 27
PARAM_ROWS = 6  # gn1 scale, gn1 bias, conv1 bias, gn2 scale, gn2 bias, conv2 bias


def residual_block(leaves: int, launches: int, channels: int = 16,
                   value_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of the block over `leaves` 8^3 leaves of
    `channels` channels in `launches` launches."""
    v = flops.LEAF_VOXELS
    per_launch = 2 * TAPS * channels * channels * 4 + PARAM_ROWS * channels * 4
    return (leaves * 2 * v * channels * value_bytes + launches * per_launch,
            leaves * 2.0 * flops.conv(v, 3, channels, channels))


def work(rec, launches: int) -> Tuple[float, float]:
    """The count of a run's record: every leaf of the window, at the 8^3
    stage's width (`pre_width`) in the run's compute dtype."""
    return residual_block(rec.leaves, launches, rec.sizes["pre_width"], rec.value_bytes)
