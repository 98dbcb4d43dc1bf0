"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.utils (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_image,
    unnormalize_image,
    load_image,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "normalize_image",
    "unnormalize_image",
    "load_image",
]
