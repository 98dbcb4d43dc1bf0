"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.models.depth (the
same public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.models.depth.bts import BtsModel
from unsupervised_pseuso_lidar_tpu_torch.models.depth.dispnet import DispNetS
from unsupervised_pseuso_lidar_tpu_torch.models.depth.resnet_dispnet import (
    DepthDecoder,
    DispResNet,
    ResnetEncoder,
)
from unsupervised_pseuso_lidar_tpu_torch.models.depth.stn_dispnet import StnDispNet

__all__ = ["BtsModel", "DispNetS", "DispResNet", "ResnetEncoder", "DepthDecoder", "StnDispNet"]
