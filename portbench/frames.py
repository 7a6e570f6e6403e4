"""The frame-sequence traffic: seeded smooth fields, made on the device.

A traffic file of kind "frames" describes a sequence of `frames` frames;
frame f holds `first_leaves + step_leaves * f` active 8^3 leaves. Each frame
is its own field: `blobs` Gaussian blobs (centre uniform in the domain,
sigma uniform in `sigma`, one amplitude per channel, uniform in
`amplitude.scalar` or `amplitude.vector`) summed on a `domain` grid,
clipped to [0, 1] (one channel) or [-1, 1], with every voxel whose largest
channel magnitude is under `threshold` set to 0. A leaf is active when any
of its voxels is not 0; the frame keeps the first active leaves in x-major
leaf order. Should a field hold fewer active leaves than its frame needs,
`extra_blobs` more are drawn from the same stream until it does, so every
seed gives every frame its size.

This is `chip_smoke.py::smooth_field` (24 blobs, sigma 18-48, the 0.02
threshold) on one 512 x 512 x 288 domain for both channel counts, written
in torch so that the field never leaves the card. The blob parameters come
from a CPU `torch.Generator` seeded with the run's seed, so a seed gives the
same frames on any device up to the rounding of the sums.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

LEAF = 8
MAX_ROUNDS = 64


def frame_sizes(traffic: Dict) -> List[int]:
    """Active leaves of each frame, in order."""
    return [traffic["first_leaves"] + traffic["step_leaves"] * f
            for f in range(traffic["frames"])]


def _blob_params(gen: torch.Generator, n: int, domain, channels: int, traffic: Dict):
    """n blobs: centres [n, 3], sigmas [n], amplitudes [n, channels] (f64, CPU)."""
    u = torch.rand((n, 4 + channels), generator=gen, dtype=torch.float64)
    centres = u[:, :3] * torch.tensor(domain, dtype=torch.float64)
    lo, hi = traffic["sigma"]
    sigmas = lo + (hi - lo) * u[:, 3]
    lo, hi = traffic["amplitude"]["scalar" if channels == 1 else "vector"]
    amps = lo + (hi - lo) * u[:, 4:]
    return centres, sigmas, amps


def _add_blobs(dense: torch.Tensor, centres, sigmas, amps) -> None:
    """dense [C, X, Y, Z] += each blob's separable Gaussian, in f32."""
    dev = dense.device
    axes = [torch.arange(s, dtype=torch.float32, device=dev) for s in dense.shape[1:]]
    for c, s, a in zip(centres.tolist(), sigmas.tolist(), amps.tolist()):
        g = [torch.exp(-((ax - ci) ** 2) / (2.0 * s * s)) for ax, ci in zip(axes, c)]
        for ch, amp in enumerate(a):
            dense[ch] += amp * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]


def _active(dense: torch.Tensor, traffic: Dict, channels: int) -> torch.Tensor:
    """[nx, ny, nz] bool: leaves holding a voxel at or above the threshold."""
    c, x, y, z = dense.shape
    lo = 0.0 if channels == 1 else -1.0
    peak = dense.clamp(lo, 1.0).abs().amax(dim=0)
    blocks = peak.view(x // LEAF, LEAF, y // LEAF, LEAF, z // LEAF, LEAF)
    return blocks.amax(dim=(1, 3, 5)) >= traffic["threshold"]


def _field(gen: torch.Generator, traffic: Dict, channels: int, need: int,
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's field [C, X, Y, Z] and its active-leaf mask, with at
    least `need` active leaves."""
    domain = tuple(traffic["domain"])
    if any(d % LEAF for d in domain):
        raise ValueError(f"domain {domain} is not a multiple of {LEAF}")
    dense = torch.zeros((channels,) + domain, dtype=torch.float32, device=device)
    n = traffic["blobs"]
    for _ in range(MAX_ROUNDS):
        _add_blobs(dense, *_blob_params(gen, n, domain, channels, traffic))
        active = _active(dense, traffic, channels)
        if int(active.sum()) >= need:
            return dense, active
        n = traffic["extra_blobs"]
    raise RuntimeError(f"no field with {need} active leaves after {MAX_ROUNDS} rounds")


def _leaves(dense: torch.Tensor, idx: torch.Tensor, traffic: Dict, channels: int) -> torch.Tensor:
    """The leaves at leaf coordinates idx [n, 3], [n, 8, 8, 8, C] f32, clipped
    and with sub-threshold voxels zeroed."""
    c, x, y, z = dense.shape
    view = dense.view(c, x // LEAF, LEAF, y // LEAF, LEAF, z // LEAF, LEAF)
    view = view.permute(1, 3, 5, 2, 4, 6, 0)
    out = view[idx[:, 0], idx[:, 1], idx[:, 2]].clamp(0.0 if channels == 1 else -1.0, 1.0)
    quiet = out.abs().amax(dim=-1, keepdim=True) < traffic["threshold"]
    return out.masked_fill(quiet, 0.0).contiguous()


def make_frames(traffic: Dict, channels: int, seed: int, device: torch.device,
                with_leaves: bool = True) -> List[Dict[str, torch.Tensor]]:
    """Every frame of the sequence on `device`: {"origins": [n, 3] int32 in
    index space, "leaves": [n, 8, 8, 8, C] f32 (with_leaves)}."""
    gen = torch.Generator().manual_seed(seed % 2**63)
    frames = []
    for need in frame_sizes(traffic):
        dense, active = _field(gen, traffic, channels, need, device)
        idx = torch.nonzero(active)[:need]
        frame = {"origins": (idx * LEAF).to(torch.int32)}
        if with_leaves:
            frame["leaves"] = _leaves(dense, idx, traffic, channels)
        frames.append(frame)
        del dense, active
    return frames
