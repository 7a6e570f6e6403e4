"""A 1-D data mesh over devices (counterpart of `vqvdb_tpu/parallel/mesh.py`).

The leaf axis is embarrassingly parallel, so a mesh is one data axis:
parameters replicated, each batch cut into `size` contiguous row blocks
(shards), one per device, as the JAX package's `P(DATA_AXIS)` cuts it. The
JAX package drives every device of a host from one process; here:

  * Inference runs in one process over its devices (`make_mesh()`: every
    visible card). Each device runs the codec's own step on its shard, on
    its own stream; the host enqueues them all, so the cards run together.
    A CPU mesh (`make_mesh(n, device="cpu")`, for the tests) runs its
    shards one after another with the same arithmetic.
  * Training runs one process per device over `torch.distributed`
    (`distributed.py`), DDP style: under an initialised group `make_mesh()`
    gives each rank its own device (cuda:LOCAL_RANK, or the CPU under gloo)
    and the group. Gradients and metrics are averaged over the group and
    the EMA quantizer's statistics summed (`models/quantizer.py`), so N
    ranks train what one process trains on the global batch.
  * A codec on a multi-process mesh runs as the JAX package's multi-host
    codec: every rank reads the same file, runs its shard of each global
    batch, and all-gathers the results, so every rank writes the same bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vqvdb_tpu_torch.core.weights import DeviceLike, resolve_device
from vqvdb_tpu_torch.parallel.distributed import all_gather_rows, local_rank
from vqvdb_tpu_torch.utils.errors import ConfigError

DATA_AXIS = "data"

TRAIN_ONE_DEVICE = (
    "training runs one process per device: a mesh in one process may hold one "
    "device. Start one rank per card (`python -m vqvdb_tpu_torch.cli train "
    "--data-parallel`, or `python -m torch.distributed.run --nproc-per-node N` "
    "with init_multi_host) and take make_mesh() in each rank")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's part of a 1-D data mesh: its devices in row order,
    the global shard count `size`, the global index of its first shard, and
    the torch.distributed group (None for a single process)."""

    devices: Tuple[torch.device, ...]
    size: int
    first_shard: int = 0
    group: Any = None
    _streams: List = dataclasses.field(default_factory=list, repr=False)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        """True when the mesh spans a process group (of any size)."""
        return self.group is not None

    def shard_rows(self, batch: int) -> int:
        if batch % self.size:
            raise ValueError(f"batch_size {batch} must divide evenly over the "
                             f"{self.size}-device mesh")
        return batch // self.size

    def stream(self, j: int):
        """Context that runs work of local shard j on its device's own
        stream (nothing on the CPU), after the work already enqueued on the
        device's current stream (uploads of its inputs, say)."""
        dev = self.devices[j]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if not self._streams:
            self._streams.extend(torch.cuda.Stream(device=d) for d in self.devices)
        self._streams[j].wait_stream(torch.cuda.current_stream(dev))
        return torch.cuda.stream(self._streams[j])

    def join(self, j: int, *outputs: torch.Tensor) -> None:
        """Hand `outputs` of local shard j's stream to its device's current
        stream: that stream waits for the shard's work, and the outputs'
        memory is kept until it has used them."""
        dev = self.devices[j]
        if dev.type != "cuda" or not self._streams:
            return
        current = torch.cuda.current_stream(dev)
        current.wait_stream(self._streams[j])
        for t in outputs:
            t.record_stream(current)

    def synchronize(self) -> None:
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_mesh(n_devices: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """A 1-D data mesh. Under an initialised process group: this rank's
    device (`device`, default cuda:LOCAL_RANK under NCCL and the CPU under
    gloo) over the group's world size. Otherwise the first `n_devices`
    cards (default: every visible card), or with device="cpu" `n_devices`
    (default 1) CPU entries."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"a mesh under a process group spans its {world} ranks, "
                             f"not {n_devices}")
        if device is None:
            device = f"cuda:{local_rank()}" if dist.get_backend() == "nccl" else "cpu"
        return Mesh((resolve_device(device),), world, dist.get_rank(), dist.group.WORLD)
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs a device, asked for {n}")
        return Mesh((dev,) * n, n)
    if dev.index is not None:
        raise ValueError("a mesh in one process takes the first n cards: pass "
                         "device='cuda' without an index")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} devices, have {count}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), n)


def _to(node, device: torch.device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{f.name: _to(getattr(node, f.name), device)
                                            for f in dataclasses.fields(node) if f.init})
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        return type(node)(*(_to(v, device) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_to(v, device) for v in node)
    return node


def replicate(tree, mesh: Mesh) -> list:
    """One copy of `tree` (dicts, lists, tuples, dataclasses of tensors, as
    the codec's params and fold constants are) per local device, in the
    mesh's order. A tree already on a device is that device's copy; the
    others are copies of its bits, so every device runs the same constants."""
    return [_to(tree, d) for d in mesh.devices]


def shard_batch(arr, mesh: Mesh) -> List[torch.Tensor]:
    """This process's shards of a global batch (numpy or tensor): contiguous
    row blocks of B / size rows, block first_shard + j on local device j."""
    per = mesh.shard_rows(arr.shape[0])
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    return [t[(mesh.first_shard + j) * per:(mesh.first_shard + j + 1) * per].to(d)
            for j, d in enumerate(mesh.devices)]


def _make_sharded_step(mesh: Mesh, step: Callable, replicate_out: bool):
    """run(shards) -> outputs: shard j through `step` on local device j's
    stream. With replicate_out every local device ends with the whole
    batch's output: all-gathered over the group across processes, copied
    between the devices of one process."""
    def run(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for j, x in enumerate(shards):
            with mesh.stream(j):
                y = step(x)
                if replicate_out and mesh.multiprocess:
                    y = all_gather_rows(y, mesh.group)
            mesh.join(j, y)
            outs.append(y)
        if replicate_out and not mesh.multiprocess:
            outs = [torch.cat([o.to(d) for o in outs]) for d in mesh.devices]
        return outs
    return run


def make_sharded_encode(mesh: Mesh, codec, replicate_out: bool = False):
    """run([leaves shard per local device]) -> [indices per device], each
    shard through `codec._encode_step` (so the same kernel launches per
    shard as per single-device batch)."""
    return _make_sharded_step(mesh, codec._encode_step, replicate_out)


def make_sharded_decode(mesh: Mesh, codec, replicate_out: bool = False):
    """run([indices shard per local device]) -> [leaves per device]."""
    return _make_sharded_step(mesh, codec._decode_step, replicate_out)


def _one_device(mesh: Mesh) -> None:
    if mesh.local_size != 1:
        raise ConfigError(TRAIN_ONE_DEVICE)


def make_sharded_train_step(mesh: Mesh, opt, mcfg, tcfg):
    """step(state, shard) -> (state, metrics, z of the shard): this rank's
    train step, gradients and metrics averaged and EMA statistics summed
    over the group, so every rank returns the same state."""
    from vqvdb_tpu_torch.train.train import train_step

    _one_device(mesh)
    return lambda state, batch: train_step(state, batch, opt, mcfg, tcfg, group=mesh.group)


def make_sharded_eval_step(mesh: Mesh, mcfg, tcfg):
    """eval(params, shard) -> metrics averaged over the group."""
    from vqvdb_tpu_torch.train.train import eval_step

    _one_device(mesh)
    return lambda params, batch: eval_step(params, batch, mcfg, tcfg, group=mesh.group)
