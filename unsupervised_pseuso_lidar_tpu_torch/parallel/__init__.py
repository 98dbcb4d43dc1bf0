"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.parallel (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
    shard_train_state,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "shard_train_state",
]
