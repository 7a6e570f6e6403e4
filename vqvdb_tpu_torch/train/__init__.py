from vqvdb_tpu_torch.train.data import LeafDataset  # noqa: F401
from vqvdb_tpu_torch.train.train import (  # noqa: F401
    TrainConfig,
    TrainState,
    eval_step,
    make_train_state,
    train as run_training,
    train_step,
)
