"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.models.pose (the
same public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.models.pose.pose_decoder import PoseDecoder
from unsupervised_pseuso_lidar_tpu_torch.models.pose.pose_fc import PoseFc
from unsupervised_pseuso_lidar_tpu_torch.models.pose.posenet import PoseNet

__all__ = ["PoseNet", "PoseFc", "PoseDecoder"]
