"""Model registry — config name -> constructor.

Counterpart of unsupervised_pseuso_lidar_tpu/models/registry.py, holding
the models ported so far (DispResNet, PoseNet).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.depth.resnet_dispnet import DispResNet
from unsupervised_pseuso_lidar_tpu_torch.models.pose.posenet import PoseNet
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "DispResNet": DispResNet,
    "PoseNet": PoseNet,
}


def build_model(
    name: str,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
    **kwargs,
) -> nn.Module:
    """Instantiate a registered model on `device`, its weights drawn from
    `generator` when one is given (else torch's global RNG)."""
    if name not in MODEL_REGISTRY:
        known = ", ".join(sorted(MODEL_REGISTRY))
        raise KeyError(f"Unknown model '{name}'. Registered models: {known}")
    device = resolve_device(device)
    model = MODEL_REGISTRY[name](**kwargs)
    if generator is not None:
        model.reset_parameters(generator)
    return model.to(device)
