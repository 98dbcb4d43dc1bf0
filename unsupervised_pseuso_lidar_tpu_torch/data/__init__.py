"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.data (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import (
    SyntheticTripletDataset,
    synthetic_triplet_batch,
)

__all__ = [
    "SyntheticTripletDataset",
    "synthetic_triplet_batch",
]
