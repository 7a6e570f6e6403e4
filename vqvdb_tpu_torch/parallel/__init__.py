"""Data parallelism on torch.distributed (counterpart of `vqvdb_tpu/parallel/`)."""

from vqvdb_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_sharded_decode,
    make_sharded_encode,
    make_sharded_eval_step,
    make_sharded_train_step,
)
