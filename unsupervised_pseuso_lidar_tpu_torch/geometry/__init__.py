"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.geometry (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import (
    euler2mat,
    mat2euler,
    rot_from_axisangle,
    transformation_from_parameters,
    pose_vec2mat,
    invert_pose,
    pose_matrix,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry.camera import (
    pixel_grid,
    backproject,
    project,
    scale_intrinsics,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    inverse_warp,
    disp_to_depth,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import (
    Calibration,
    decompose_projection,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry import oxts

__all__ = [
    "euler2mat",
    "mat2euler",
    "rot_from_axisangle",
    "transformation_from_parameters",
    "pose_vec2mat",
    "invert_pose",
    "pose_matrix",
    "pixel_grid",
    "backproject",
    "project",
    "scale_intrinsics",
    "inverse_warp",
    "disp_to_depth",
    "Calibration",
    "decompose_projection",
    "oxts",
]
