"""Training loop: AdamW + cosine, EMA codebook, dead-code reset,
checkpoint/resume, validation (counterpart of `vqvdb_tpu/train/train.py`).

  * loss = 0.8 MSE + 0.2 L1 + commitment; an optional 3D Sobel gradient
    loss (`grad_loss_weight`, default 0).
  * AdamW (lr 1e-4, weight decay 1e-4 on every encoder/decoder leaf, betas
    .9/.999, eps 1e-8) with the learning rate of a cosine decay over the
    total steps, taken at the step count before the update: `AdamW` below
    writes out `optax.adamw(optax.cosine_decay_schedule(...))` update for
    update. The EMA codebook is not a gradient leaf; the forward updates it.
  * Mixed precision: batches are cast to `compute_dtype` for the conv
    stacks; norms, losses and the EMA statistics stay f32.
  * Dead-code reset every `dead_code_interval` epochs from the epoch's first
    batch of encoder outputs.
  * Checkpoints (train/checkpoint.py) with resume and a best-val slot.

A train step runs eagerly: autograd through the eager graph (the residual
block unfused, as the JAX package trains it), the nearest-code and
dequantize kernels in the quantizer on the card. Random draws come from
`torch.Generator`s seeded from `TrainConfig.seed`, one per use (`generator`),
so a resumed run draws what an uninterrupted one would.

Data parallelism (`mesh=`, `parallel/mesh.py`) runs one process per device:
every rank iterates the same seeded global batches and steps on its
`local_batch_slice`; `train_step(group=)` averages the gradients and
metrics over the group and sums the EMA statistics, so each rank ends each
step with the same state, that of one process on the global batch. The
dead-code reset gathers the ranks' encoder outputs of the epoch's first
batch, and every rank draws the same reset. Rank 0 alone logs and writes
checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vqvdb_tpu_torch.core.config import ModelConfig
from vqvdb_tpu_torch.core.weights import DeviceLike, resolve_device
from vqvdb_tpu_torch.models.quantizer import VQState
from vqvdb_tpu_torch.models.vqvae import (
    decoder_apply,
    encoder_apply,
    init_vqvae_params,
    quantize_infer,
    quantize_train_forward,
    reset_dead,
)
from vqvdb_tpu_torch.parallel.distributed import all_gather_rows, all_reduce_mean
from vqvdb_tpu_torch.parallel.mesh import TRAIN_ONE_DEVICE, Mesh
from vqvdb_tpu_torch.utils.errors import ConfigError

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters (the JAX package's fields and defaults: the
    reference scalar recipe)."""

    epochs: int = 30
    batch_size: int = 2048
    lr: float = 1e-4
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    mse_weight: float = 0.8
    l1_weight: float = 0.2
    grad_loss_weight: float = 0.0  # 3D Sobel loss
    dead_code_interval: int = 5  # epochs between dead-code resets
    val_fraction: float = 0.2
    compute_dtype: str = "bfloat16"
    # Dtype of the device-resident pool (train/fast.py; the host loop
    # ignores it). "bfloat16" halves its memory but rounds the
    # reconstruction target to bf16: harmless where the model's error is far
    # above that rounding, wrong for high-PSNR scalar tiers.
    pool_dtype: str = "float32"
    # train/fast.py only: split the train pool into this many equal
    # segments and run each dead-code interval's epochs over one of them,
    # rotating per interval (an epoch then covers 1/S of the pool).
    pool_segments: int = 1
    seed: int = 0
    log_every: int = 50
    checkpoint_every_epochs: int = 1
    max_checkpoints: int = 3

    def __post_init__(self):
        for name in ("compute_dtype", "pool_dtype"):
            if getattr(self, name) not in ("bfloat16", "float32"):
                raise ValueError(f"{name} must be 'bfloat16' or 'float32', got "
                                 f"{getattr(self, name)!r}")


class Placement(NamedTuple):
    """Where this process trains: its device, the process group (None for
    one process), its rank and the world size."""

    device: torch.device
    group: Any
    rank: int
    world: int

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch (`local_batch_slice`)."""
        if batch % self.world:
            raise ValueError(f"batch_size {batch} must divide evenly over the "
                             f"{self.world} ranks")
        per = batch // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def placement(mesh: Optional[Mesh], device: DeviceLike) -> Placement:
    """This process's part of `mesh` (or of one device without one). A mesh
    of several devices in one process raises ConfigError: training takes
    one process per device."""
    if mesh is None:
        return Placement(resolve_device(device), None, 0, 1)
    if mesh.local_size != 1:
        raise ConfigError(TRAIN_ONE_DEVICE)
    return Placement(mesh.devices[0], mesh.group, mesh.first_shard, mesh.size)


class TrainState(NamedTuple):
    params: Params  # {encoder, decoder, vq} as init_vqvae_params makes it
    opt_state: Dict[str, Any]  # {"count": int, "mu": tree, "nu": tree}
    step: int


def generator(device: torch.device, seed: int, *stream: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, *stream): one per use
    (stream 0 init, 1 the dead-code reset of an epoch, 2 the permutation of
    a device-resident epoch), so no use shifts another's draws."""
    words = np.random.SeedSequence([seed, *stream]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(words[0]) << 31 | int(words[1])) & (2**63 - 1))


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the dicts' key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """`tree`'s structure with `leaves` (in tree_leaves order) in place."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    return build(tree)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(cosine_decay_schedule(lr, total_steps), b1, b2, eps=1e-8,
    weight_decay) written out: for each leaf,

        mu <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
        u  <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p  <- p + (-lr(t - 1)) u

    with t the count after the increment and lr(c) = lr * 0.5 (1 + cos(pi
    min(c, T) / T)). The arithmetic is f32 in that order, the bias
    corrections too (as optax computes them); the learning rate is computed
    in f64 and rounded to f32 once. Leaves go through torch's multi-tensor
    (`_foreach`) kernels."""

    lr: float
    total_steps: int
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def schedule(self, count: int) -> float:
        t = max(self.total_steps, 1)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * min(count, t) / t))

    def init(self, trainable) -> Dict[str, Any]:
        return {"count": 0, "mu": tree_map(torch.zeros_like, trainable),
                "nu": tree_map(torch.zeros_like, trainable)}

    def update(self, grads: List[torch.Tensor], opt_state: Dict[str, Any],
               params: List[torch.Tensor]):
        """(new param leaves, new opt_state) for leaves in tree order."""
        count = opt_state["count"] + 1
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        mu = torch._foreach_add(torch._foreach_mul(grads, f32(1.0 - self.b1)),
                                torch._foreach_mul(tree_leaves(opt_state["mu"]), f32(self.b1)))
        sq = torch._foreach_mul(grads, grads)
        nu = torch._foreach_add(torch._foreach_mul(sq, f32(1.0 - self.b2)),
                                torch._foreach_mul(tree_leaves(opt_state["nu"]), f32(self.b2)))
        one, t = np.float32(1.0), np.float32(count)
        mu_hat = torch._foreach_div(mu, float(one - np.float32(self.b1) ** t))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, float(one - np.float32(self.b2) ** t)))
        torch._foreach_add_(denom, f32(self.eps))
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(upd, torch._foreach_mul(params, f32(self.weight_decay)))
        torch._foreach_mul_(upd, -f32(self.schedule(count - 1)))
        new = torch._foreach_add(params, upd)
        return new, {"count": count, "mu": tree_unflatten(opt_state["mu"], mu),
                     "nu": tree_unflatten(opt_state["nu"], nu)}


def make_optimizer(tcfg: TrainConfig, total_steps: int) -> AdamW:
    return AdamW(lr=tcfg.lr, total_steps=total_steps, b1=tcfg.beta1, b2=tcfg.beta2,
                 weight_decay=tcfg.weight_decay)


def _trainable(params: Params) -> Params:
    return {"encoder": params["encoder"], "decoder": params["decoder"]}


def make_train_state(mcfg: ModelConfig, tcfg: TrainConfig, total_steps: int,
                     device: DeviceLike = None, params: Optional[Params] = None
                     ) -> TrainState:
    """`params` (default: drawn on the CPU from generator(seed, 0), so both
    devices start from the same params) moved to `device`, and a fresh
    optimizer state."""
    dev = resolve_device(device)
    if params is None:
        params = init_vqvae_params(generator(torch.device("cpu"), tcfg.seed, 0), mcfg)
    params = tree_map(lambda t: t.to(dev), params)
    opt = make_optimizer(tcfg, total_steps)
    return TrainState(params=params, opt_state=opt.init(_trainable(params)), step=0)


# ---------------------------------------------------------------------------
# Sobel gradient loss
# ---------------------------------------------------------------------------

def _sobel_kernels() -> np.ndarray:
    """3D Sobel operators along x / y / z as a (3,3,3,1,3) DHWIO kernel."""
    smooth = np.array([1.0, 2.0, 1.0], np.float32)
    diff = np.array([-1.0, 0.0, 1.0], np.float32)
    gx = np.einsum("i,j,k->ijk", diff, smooth, smooth)
    gy = np.einsum("i,j,k->ijk", smooth, diff, smooth)
    gz = np.einsum("i,j,k->ijk", smooth, smooth, diff)
    return np.stack([gx, gy, gz], axis=-1)[:, :, :, None, :]


_SOBEL_OIDHW = np.ascontiguousarray(_sobel_kernels().transpose(4, 3, 0, 1, 2))


def gradient_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean MSE between the Sobel gradients of recon and target, per channel."""
    w = torch.from_numpy(_SOBEL_OIDHW).to(recon.device)

    def grads(v):
        # (B, D, H, W, C) -> (B*C, 1, D, H, W): each channel on its own
        x = v.to(torch.float32).permute(0, 4, 1, 2, 3)
        b, c = x.shape[:2]
        g = F.conv3d(x.reshape(b * c, 1, *x.shape[2:]), w, padding=1)
        return g.reshape(b, c, 3, *x.shape[2:])

    return torch.mean(torch.square(grads(recon) - grads(target)))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _recon_terms(recon: torch.Tensor, batch: torch.Tensor, tcfg: TrainConfig):
    target = batch.to(torch.float32)
    mse = torch.mean(torch.square(recon - target))
    l1 = torch.mean(torch.abs(recon - target))
    err = tcfg.mse_weight * mse + tcfg.l1_weight * l1
    return target, mse, l1, err


def _forward_loss(trainable: Params, vq_state: VQState, batch: torch.Tensor,
                  mcfg: ModelConfig, tcfg: TrainConfig, group=None):
    """(loss, (new VQState, metrics, z)) for the trainable {encoder, decoder};
    `group` sums the EMA statistics over a process group."""
    x = batch.to(getattr(torch, tcfg.compute_dtype))
    z = encoder_apply(trainable["encoder"], x, mcfg)
    quantized, new_vq, vq_loss, perplexity = quantize_train_forward(vq_state, z, mcfg,
                                                                    group=group)
    recon = decoder_apply(trainable["decoder"], quantized, mcfg)  # f32
    target, recon_mse, recon_l1, recon_err = _recon_terms(recon, batch, tcfg)
    if tcfg.grad_loss_weight > 0.0:
        recon_err = recon_err + tcfg.grad_loss_weight * gradient_loss(recon, target)
    loss = recon_err + vq_loss
    metrics = {"loss": loss, "recon_mse": recon_mse, "recon_l1": recon_l1,
               "recon_err": recon_err, "vq_loss": vq_loss, "perplexity": perplexity}
    return loss, (new_vq, metrics, z)


def _mean_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    values = [v.detach() for v in metrics.values()]
    if group is not None:
        values = list(all_reduce_mean([torch.stack(values)], group)[0])
    return dict(zip(metrics, values))


def train_step(state: TrainState, batch: torch.Tensor, opt: AdamW,
               mcfg: ModelConfig, tcfg: TrainConfig, *, group=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor], torch.Tensor]:
    """One optimizer step: (new state, metrics as 0-d tensors, encoder
    outputs z for the dead-code reset). `state` is left as it was. With
    `group` (a torch.distributed group; `batch` is this rank's shard) the
    gradients and metrics are averaged over the group and the EMA
    statistics summed before the updates, in the JAX package's `pmean` /
    `psum` places; z stays the shard's."""
    trainable = tree_map(lambda t: t.detach().requires_grad_(),
                         _trainable(state.params))
    leaves = tree_leaves(trainable)
    with torch.enable_grad():
        loss, (new_vq, metrics, z) = _forward_loss(
            trainable, VQState(**state.params["vq"]), batch, mcfg, tcfg, group)
        grads = torch.autograd.grad(loss, leaves)
    grads = all_reduce_mean(grads, group)
    with torch.no_grad():
        new_leaves, new_opt = opt.update(list(grads), state.opt_state,
                                         [t.detach() for t in leaves])
    new_trainable = tree_unflatten(trainable, new_leaves)
    params = {"encoder": new_trainable["encoder"], "decoder": new_trainable["decoder"],
              "vq": new_vq._asdict()}
    return (TrainState(params, new_opt, state.step + 1), _mean_metrics(metrics, group),
            z.detach())


@torch.no_grad()
def eval_step(params: Params, batch: torch.Tensor, mcfg: ModelConfig,
              tcfg: TrainConfig, *, group=None) -> Dict[str, torch.Tensor]:
    """Validation forward: the training loss without EMA or optimizer
    updates, with inference quantization; `group` averages the metrics."""
    x = batch.to(getattr(torch, tcfg.compute_dtype))
    z = encoder_apply(params["encoder"], x, mcfg)
    _, quant_flat = quantize_infer(VQState(**params["vq"]),
                                   z.reshape(-1, mcfg.embedding_dim), mcfg, z.dtype)
    quantized = quant_flat.reshape(z.shape)
    commit = mcfg.commitment_cost * torch.mean(
        torch.square(z.to(torch.float32) - quantized.to(torch.float32)))
    recon = decoder_apply(params["decoder"], quantized, mcfg)
    _, recon_mse, _, recon_err = _recon_terms(recon, batch, tcfg)
    return _mean_metrics({"loss": recon_err + commit, "recon_mse": recon_mse,
                          "recon_err": recon_err, "vq_loss": commit}, group)


def apply_reset(state: TrainState, gen: torch.Generator, z: torch.Tensor,
                mcfg: ModelConfig) -> Tuple[TrainState, torch.Tensor]:
    """Dead-code reset of the state's codebook from encoder outputs z:
    (new state, number of dead codes as a 0-d tensor)."""
    flat_z = z.reshape(-1, mcfg.embedding_dim).to(torch.float32)
    new_vq, n_dead = reset_dead(gen, VQState(**state.params["vq"]), flat_z, mcfg)
    params = dict(state.params, vq=new_vq._asdict())
    return state._replace(params=params), n_dead


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _quiet(*_args) -> None:
    """The log of a rank other than 0."""


class _Uploader:
    """Host batches -> `device`. On the card each batch is staged in one of
    two pinned buffers and copied without a wait, so the host gathers the
    next batch while the device trains on this one; a buffer is reused only
    after its copy has finished."""

    def __init__(self, device: torch.device):
        self.device = device
        self.slots: List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = []
        self.turn = 0

    def __call__(self, batch: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type != "cuda":
            return host.to(self.device)
        if len(self.slots) < 2:
            self.slots.append((torch.empty_like(host).pin_memory(), None))
        buf, done = self.slots[self.turn]
        if done is not None:
            done.synchronize()
        if buf.shape != host.shape:
            buf = torch.empty_like(host).pin_memory()
        buf.copy_(host)
        out = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.slots[self.turn] = (buf, event)
        self.turn ^= 1
        return out


def train(dataset, mcfg: ModelConfig, tcfg: TrainConfig, *,
          checkpoint_dir: Optional[str] = None, resume: bool = True, mesh=None,
          log_fn=print, device: DeviceLike = None) -> Tuple[TrainState, Dict[str, list]]:
    """Training driver over a LeafDataset, on `device` (default `cuda`), or
    on this rank's device of `mesh` (module docstring). Metrics stay on the
    device during an epoch; the host reads them at the epoch's end and at
    each `log_every` step. Returns (final state, history), the same on
    every rank."""
    from vqvdb_tpu_torch.train.checkpoint import CheckpointManager

    place = placement(mesh, device)
    dev, group = place.device, place.group
    mine = place.rows(tcfg.batch_size)
    if place.rank:
        log_fn = _quiet
    train_view, val_view = dataset.split(tcfg.val_fraction, seed=tcfg.seed)
    steps_per_epoch = max(len(train_view) // tcfg.batch_size, 1)
    total_steps = steps_per_epoch * tcfg.epochs
    opt = make_optimizer(tcfg, total_steps)

    state = make_train_state(mcfg, tcfg, total_steps, dev)
    start_epoch = 0
    best_val = float("inf")
    manager = None
    if checkpoint_dir:
        manager = CheckpointManager(checkpoint_dir, max_to_keep=tcfg.max_checkpoints)
        if resume:
            restored = manager.restore_latest(state)
            if restored is not None:
                step0, state = restored
                start_epoch = int(step0) // steps_per_epoch
                m = manager.read_metrics(step0)
                if m:
                    best_val = m.get("best_val", best_val)
                log_fn(f"[train] resumed from step {step0} (epoch {start_epoch})")

    upload = _Uploader(dev)
    history: Dict[str, list] = {"train_recon": [], "train_vq": [], "val_loss": [],
                                "perplexity": []}
    for epoch in range(start_epoch, tcfg.epochs):
        t0 = time.perf_counter()
        acc = torch.zeros(2, dtype=torch.float64, device=dev)  # recon_err, vq_loss
        last_ppl = torch.zeros((), device=dev)
        first_z = None
        n_steps = 0
        for i, batch in enumerate(train_view.batches(
                tcfg.batch_size, shuffle=True, seed=tcfg.seed, epoch=epoch)):
            state, metrics, z = train_step(state, upload(batch[mine]), opt, mcfg, tcfg,
                                           group=group)
            if i == 0:
                first_z = z
            n_steps += 1
            acc += torch.stack([metrics["recon_err"], metrics["vq_loss"]]).double()
            last_ppl = metrics["perplexity"]
            if (i + 1) % tcfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                log_fn(f"[train] epoch {epoch + 1} step {i + 1}/{steps_per_epoch} "
                       f"recon={m['recon_err']:.5f} vq={m['vq_loss']:.5f} "
                       f"ppl={m['perplexity']:.1f}")

        if (epoch + 1) % tcfg.dead_code_interval == 0 and first_z is not None:
            # The global batch's z: the ranks' shards in rank order.
            state, n_dead = apply_reset(state, generator(dev, tcfg.seed, 1, epoch),
                                        all_gather_rows(first_z, group), mcfg)
            if int(n_dead):
                log_fn(f"[train] reset {int(n_dead)} dead codes")

        val_losses = [eval_step(state.params, upload(b[mine]), mcfg, tcfg,
                                group=group)["loss"]
                      for b in val_view.batches(tcfg.batch_size, drop_remainder=True)]
        val_loss = (float(torch.stack(val_losses).double().mean()) if val_losses
                    else float("nan"))
        denom = max(n_steps, 1)
        run_recon, run_vq = (acc / denom).tolist()
        last = float(last_ppl)
        history["train_recon"].append(run_recon)
        history["train_vq"].append(run_vq)
        history["val_loss"].append(val_loss)
        history["perplexity"].append(last)
        log_fn(f"[train] epoch {epoch + 1:02d}/{tcfg.epochs} recon={run_recon:.6f} "
               f"vq={run_vq:.6f} val={val_loss:.6f} ppl={last:.1f} "
               f"({time.perf_counter() - t0:.1f}s)")

        if manager and not place.rank:
            # Selection metric: val loss, or the epoch's train loss when the
            # val split holds no full batch.
            select = val_loss if not np.isnan(val_loss) else run_recon
            improved = select < best_val
            best_val = min(best_val, select)
            if improved:
                manager.save_best(state.step, state,
                                  metrics={"val_loss": val_loss, "epoch": epoch + 1})
            if improved or (epoch + 1) % tcfg.checkpoint_every_epochs == 0:
                manager.save(state.step, state,
                             metrics={"best_val": best_val, "val_loss": val_loss,
                                      "epoch": epoch + 1})
    return state, history
