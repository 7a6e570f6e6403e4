"""Processes and collectives (counterpart of `vqvdb_tpu/parallel/distributed.py`).

Training runs one process per device, as DDP does: `init_multi_host` joins
the processes into one `torch.distributed` group (NCCL for ranks on a card,
gloo for ranks on the CPU), every rank iterates the same global batches and
feeds its `local_batch_slice`, and the collectives below stand where the
JAX package's `pmean` / `psum` / `all_gather` ride its mesh axis. A ring
all-reduce leaves every rank the same bits, so the ranks' states stay
bit-identical to each other.

Nothing here starts a process: `torch.distributed.run` or the CLI's
`train --data-parallel` (`cli.py`) does, and gives each rank its address,
world size and rank.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _init_method(address: str) -> str:
    """"host:port" (the JAX form) -> "tcp://host:port"; a URL
    ("tcp://...", "file://...", "env://") stays as it is."""
    return address if "://" in address else f"tcp://{address}"


def local_rank() -> int:
    """This process's card on its host: LOCAL_RANK (set by
    torch.distributed.run and by the CLI's spawner), else the global rank."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def init_multi_host(coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None, *,
                    backend: Optional[str] = None) -> dict:
    """Join this process to the group of `num_processes` ranks at
    `coordinator_address` (a no-op for a single process, or when a group
    is already initialised). `backend` defaults to nccl where a card is
    visible (the rank then drives cuda:LOCAL_RANK) and gloo on the CPU.
    Returns {process_index, process_count, local_devices, global_devices}:
    under a group each rank drives one device."""
    if not dist.is_initialized() and (
            (num_processes is not None and num_processes > 1) or coordinator_address):
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
        dist.init_process_group(backend, init_method=_init_method(
            coordinator_address or "env://"), world_size=num_processes, rank=process_id)
    if dist.is_initialized():
        world = dist.get_world_size()
        return {"process_index": dist.get_rank(), "process_count": world,
                "local_devices": 1, "global_devices": world}
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": 0, "process_count": 1, "local_devices": local,
            "global_devices": local}


def local_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous rows of a global batch: rank r of W feeds
    rows [r * B/W, (r + 1) * B/W), the row order of the mesh's shards."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def global_batch_from_local(mesh, local_rows: np.ndarray) -> torch.Tensor:
    """This process's rows on its device. With one process that is the
    whole batch; across processes each rank keeps its own rows, because its
    step is local (the collectives join the ranks inside the step)."""
    return torch.from_numpy(np.ascontiguousarray(local_rows)).to(mesh.devices[0])


# ---------------------------------------------------------------------------
# Collectives (a `group` of None is a single process: nothing to reduce)
# ---------------------------------------------------------------------------

def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The element-wise sums over the group's ranks of `tensors` (one dtype,
    one device), in one collective; each result keeps its tensor's layout."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [torch.empty_like(t).copy_(r) for t, r in
            zip(tensors, torch._utils._unflatten_dense_tensors(flat, tensors))]


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The group's sums divided by its size, where the JAX package takes
    `pmean`."""
    if group is None:
        return list(tensors)
    out = all_reduce_sum(tensors, group)
    torch._foreach_div_(out, float(world_size(group)))
    return out


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `t` stacked along dim 0 in rank order, on every rank.
    Gloo takes uint8, int32 and floating tensors (not int16)."""
    if group is None:
        return t
    world = world_size(group)
    out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather(list(out.chunk(world)), t.contiguous(), group=group)
    return out
