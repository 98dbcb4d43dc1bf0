"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.train (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.train.config import (
    Config,
    load_config,
)
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    create_train_state,
    make_train_step,
)

__all__ = [
    "Config",
    "load_config",
    "Trainer",
    "TrainState",
    "create_train_state",
    "make_train_step",
]
