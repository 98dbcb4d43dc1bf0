"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.ops: its
__init__'s public names that the port has. band_coverage and
grid_sample_mxu belong to the TPU's banded warp, which the port's exact
warp replaces; resize_nearest comes with BtsModel (ROADMAP.md slice 9).
Importing it builds no kernel."""

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import (
    grid_sample,
    resize_bilinear,
    upsample2x_nearest,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import (
    ssim_distance,
    ssim_distance_fused,
)

__all__ = [
    "grid_sample",
    "resize_bilinear",
    "upsample2x_nearest",
    "ssim_distance",
    "ssim_distance_fused",
]
