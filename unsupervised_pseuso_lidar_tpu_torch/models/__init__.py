"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.models (the same
public names as its __init__)."""

from unsupervised_pseuso_lidar_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    build_model,
    register_model,
)

__all__ = [
    "MODEL_REGISTRY",
    "build_model",
    "register_model",
]
