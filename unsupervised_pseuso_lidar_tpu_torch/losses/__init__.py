"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.losses (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import (
    l1_loss,
    photometric_loss,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.smoothness import (
    smooth_loss,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.reprojection import (
    reprojection_loss,
    min_reprojection_loss,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.total import (
    Losses,
    total_loss,
)

__all__ = [
    "l1_loss",
    "photometric_loss",
    "smooth_loss",
    "reprojection_loss",
    "min_reprojection_loss",
    "Losses",
    "total_loss",
]
