"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.eval (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.eval.metrics import (
    compute_errors,
)
from unsupervised_pseuso_lidar_tpu_torch.eval.pose import (
    make_pose_eval_step,
    pose_errors,
)

__all__ = [
    "compute_errors",
    "make_pose_eval_step",
    "pose_errors",
]
