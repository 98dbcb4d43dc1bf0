"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.pseudolidar (the
same public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import (
    export_program,
    load_exported,
    make_depth_cloud_fn,
    make_depth_fn,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
    PseudoLiDAR,
    depth_to_pointcloud,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.velo2img import (
    project_img_to_velo,
    project_velo_to_depth_image,
)

__all__ = [
    "PseudoLiDAR",
    "depth_to_pointcloud",
    "export_program",
    "load_exported",
    "make_depth_cloud_fn",
    "make_depth_fn",
    "project_velo_to_depth_image",
    "project_img_to_velo",
]
