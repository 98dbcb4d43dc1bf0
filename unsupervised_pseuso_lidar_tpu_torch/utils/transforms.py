"""ImageNet normalization (numpy).

Counterpart of unsupervised_pseuso_lidar_tpu/utils/transforms.py
(IMAGENET_MEAN / IMAGENET_STD / normalize_image); the image loaders there
come with the data slice.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalize a float HWC image in [0, 1]."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD
