"""Device-resident training (counterpart of `vqvdb_tpu/train/fast.py`).

The leaf datasets this codec trains on are small next to the card's memory
(1M leaves = 2 GiB in f32), so the pool stays on the device: each epoch
draws its permutation there from a `torch.Generator`, gathers its batches
there, runs `train.train_step` on each and sums the step metrics there; a
per-epoch validation over the resident held-out shard follows. The host
issues the steps without waiting for them and reads the device once per
dead-code interval (the interval's metrics with its dead-code count).

The math is `train.train_step`'s; `epoch_permutation` gives the order an
epoch takes, so the host loop over the same batches gives the same state.

With a mesh (one process per device, `parallel/mesh.py`) each rank holds the
whole pool, draws the same epoch permutation, and steps on its slice of each
step's rows; the losses are averaged over the group's equal slices, and the
dead-code reset's probe batch, encoded by every rank from the same params,
draws the same reset everywhere. Rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.weights import DeviceLike
from vqvdb_tpu_torch.models.vqvae import encoder_apply
from vqvdb_tpu_torch.train.train import (
    AdamW,
    Placement,
    TrainConfig,
    TrainState,
    _quiet,
    apply_reset,
    eval_step,
    generator,
    make_optimizer,
    make_train_state,
    placement,
    train_step,
)

METRIC_KEYS = ("loss", "recon_err", "vq_loss", "perplexity", "val_loss")


def epoch_permutation(tcfg: TrainConfig, n: int, epoch: int,
                      device: torch.device) -> torch.Tensor:
    """The order in which epoch `epoch` (0-based over the whole run) visits
    the `n` pool leaves: int64 [n] on `device`."""
    return torch.randperm(n, generator=generator(device, tcfg.seed, 2, epoch),
                          device=device)


def run_epochs(state: TrainState, data: torch.Tensor, val_data: torch.Tensor,
               opt: AdamW, mcfg: ModelConfig, tcfg: TrainConfig, first_epoch: int,
               epochs: int, place: Optional[Placement] = None
               ) -> Tuple[TrainState, torch.Tensor]:
    """`epochs` epochs over the resident pool `data` [N, 8, 8, 8, C] (the
    first (N // batch) * batch leaves of each permutation), each followed by
    validation over `val_data`'s full batches (NaN without one). Returns
    (state, metrics [epochs, 5] on the device: loss / recon / vq / perplexity
    means of the steps, then val loss). Nothing here waits for the device.
    Under a `place` of several ranks each step and val batch runs on this
    rank's slice of its rows."""
    bs = tcfg.batch_size
    n = data.shape[0]
    steps = n // bs
    if steps == 0:
        raise ValueError(f"batch_size {bs} exceeds dataset size {n}")
    place = place or Placement(data.device, None, 0, 1)
    mine = place.rows(bs)
    val_steps = val_data.shape[0] // bs
    rows = []
    for e in range(first_epoch, first_epoch + epochs):
        perm = epoch_permutation(tcfg, n, e, data.device)
        acc = torch.zeros(4, dtype=torch.float32, device=data.device)
        for i in range(steps):
            batch = data.index_select(0, perm[i * bs:(i + 1) * bs][mine])
            state, metrics, _ = train_step(state, batch, opt, mcfg, tcfg, group=place.group)
            acc += torch.stack([metrics[k].to(torch.float32) for k in METRIC_KEYS[:4]])
        if val_steps:
            val = torch.zeros((), dtype=torch.float32, device=data.device)
            for i in range(val_steps):
                val += eval_step(state.params, val_data[i * bs:(i + 1) * bs][mine],
                                 mcfg, tcfg, group=place.group)["loss"].to(torch.float32)
            val = val / val_steps
        else:
            val = torch.full((), float("nan"), device=data.device)
        rows.append(torch.cat([acc / steps, val[None]]))
    return state, torch.stack(rows)


def train_on_device(dataset_leaves: np.ndarray, mcfg: ModelConfig, tcfg: TrainConfig, *,
                    init_state: Optional[TrainState] = None,
                    checkpoint_dir: Optional[str] = None, resume: bool = True,
                    mesh=None, log_fn: Callable = print,
                    device: DeviceLike = None) -> Tuple[TrainState, np.ndarray]:
    """Device-resident training driver, on `device` (default `cuda`).

    Holds out `val_fraction` of the leaves (a numpy permutation seeded by
    `seed`, as the JAX package splits), keeps both shards resident in
    `pool_dtype`, runs `dead_code_interval` epochs at a time, then resets
    dead codes from a probe batch (the pool's first batch) except after the
    last interval. With `pool_segments` S > 1 the train shard is cut into S
    segments of n // S leaves (starts spread evenly, so adjacent segments
    overlap to cover the remainder) and interval j runs over segment j mod
    S. With `checkpoint_dir` every interval ends in a checkpoint and a new
    best val loss in the `best/` slot. With `mesh`, this rank's part of a
    data-parallel run (module docstring). Returns (final state, metrics
    [epochs, 5] = loss / recon / vq / perplexity / val_loss)."""
    from vqvdb_tpu_torch.train.checkpoint import CheckpointManager

    place = placement(mesh, device)
    dev = place.device
    place.rows(tcfg.batch_size)  # ValueError unless the ranks split it evenly
    if place.rank:
        log_fn = _quiet
    leaves = np.asarray(dataset_leaves, np.float32)
    if leaves.ndim == 4:
        leaves = leaves[..., None]
    n_total = leaves.shape[0]
    n_val = int(n_total * tcfg.val_fraction)
    split = np.random.default_rng(tcfg.seed).permutation(n_total)
    val_idx, train_idx = split[:n_val], split[n_val:]
    n = train_idx.shape[0]
    n_segs = max(1, int(tcfg.pool_segments))
    n_run = n // n_segs if n_segs > 1 else n
    if n_segs > 1 and n_run < tcfg.batch_size:
        raise ValueError(f"pool_segments={n_segs} leaves segments of {n_run} leaves, "
                         f"below batch_size {tcfg.batch_size}")
    steps_per_epoch = max(n_run // tcfg.batch_size, 1)
    total_steps = steps_per_epoch * tcfg.epochs
    opt = make_optimizer(tcfg, total_steps)
    state = init_state or make_train_state(mcfg, tcfg, total_steps, dev)

    manager = None
    done = 0
    best_val = float("inf")
    if checkpoint_dir:
        manager = CheckpointManager(checkpoint_dir, max_to_keep=tcfg.max_checkpoints)
        if resume:
            restored = manager.restore_latest(state)
            if restored is not None:
                step0, state = restored
                done = int(step0) // steps_per_epoch
                log_fn(f"[fast-train] resumed at epoch {done} (step {step0})")
            best_val = float((manager.read_best_metrics() or {}).get("val_loss", best_val))

    interval = max(tcfg.dead_code_interval, 1)
    n_spans = -(-tcfg.epochs // interval)
    if n_segs > 1 and n_spans < n_segs:
        log_fn(f"[fast-train] WARNING: epochs={tcfg.epochs} gives {n_spans} interval(s) "
               f"but pool_segments={n_segs}; segments {n_spans}..{n_segs - 1} will never "
               "be trained on. Raise epochs or lower pool_segments.")
    pool_dt = getattr(torch, tcfg.pool_dtype)
    seg_starts = [(i * (n - n_run)) // (n_segs - 1) if n_segs > 1 else 0
                  for i in range(n_segs)]
    segments = [torch.from_numpy(leaves[train_idx[s:s + n_run]]).to(dev, pool_dt)
                for s in seg_starts]
    val_data = torch.from_numpy(leaves[val_idx]).to(dev, pool_dt)

    traces = []
    while done < tcfg.epochs:
        span = min(interval, tcfg.epochs - done)
        data = segments[(done // interval) % n_segs]
        state, trace = run_epochs(state, data, val_data, opt, mcfg, tcfg, done, span,
                                  place)
        n_dead = torch.zeros((), dtype=torch.int64, device=dev)
        if done + span < tcfg.epochs:
            probe = data[: min(tcfg.batch_size, n_run)]
            with torch.no_grad():
                z = encoder_apply(state.params["encoder"],
                                  probe.to(getattr(torch, tcfg.compute_dtype)), mcfg)
            state, n_dead = apply_reset(state, generator(dev, tcfg.seed, 1, done + span - 1),
                                        z, mcfg)
        # The interval's one read of the device.
        host = torch.cat([trace.reshape(-1).double(), n_dead.reshape(1).double()]).cpu()
        traces.append(host[:-1].reshape(span, len(METRIC_KEYS)).numpy().astype(np.float32))
        done += span
        m = traces[-1][-1]
        val_loss = float(m[4])
        log_fn(f"[fast-train] epoch {done}/{tcfg.epochs} loss={m[0]:.5f} "
               f"recon={m[1]:.5f} vq={m[2]:.5f} ppl={m[3]:.1f} val={val_loss:.5f}")
        if int(host[-1]):
            log_fn(f"[fast-train] reset {int(host[-1])} dead codes")
        if manager is not None and not place.rank:
            manager.save(state.step, state, metrics={"epoch": done, "loss": float(m[0]),
                                                     "val_loss": val_loss})
            select = val_loss if np.isfinite(val_loss) else float(m[0])
            if select < best_val:
                best_val = select
                manager.save_best(state.step, state,
                                  metrics={"val_loss": select, "epoch": done})
                log_fn(f"[fast-train] new best val={select:.5f} (epoch {done})")
    if not traces:  # resumed at the end: nothing left to train
        return state, np.zeros((0, len(METRIC_KEYS)), np.float32)
    return state, np.concatenate(traces, axis=0)
