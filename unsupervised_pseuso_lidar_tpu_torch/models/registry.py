"""Model registry — config name -> constructor.

Counterpart of unsupervised_pseuso_lidar_tpu/models/registry.py
(register_model :16, build_model :24), holding the models ported so far
(DispResNet, PoseNet, PoseFc) and any a user registers.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.depth.resnet_dispnet import DispResNet
from unsupervised_pseuso_lidar_tpu_torch.models.pose.pose_fc import PoseFc
from unsupervised_pseuso_lidar_tpu_torch.models.pose.posenet import PoseNet
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "DispResNet": DispResNet,
    "PoseNet": PoseNet,
    "PoseFc": PoseFc,
}
# the JAX package's other models, by the ROADMAP.md slice that ports them
NOT_PORTED = {"BtsModel": 9, "DispNetS": 10, "StnDispNet": 10, "PoseDecoder": 10}
# models whose parameter shapes depend on the image size (PoseFc's first
# Linear); flax infers such widths at init, torch needs them when building
_TAKES_IMAGE_SHAPE = {"PoseFc"}


def register_model(name: str):
    """Class decorator: register a model constructor under `name` (a
    registered name is built even where NOT_PORTED lists it). A model built
    with a generator must have reset_parameters(generator)."""
    def wrap(ctor):
        MODEL_REGISTRY[name] = ctor
        return ctor

    return wrap


def build_model(
    name: str,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
    image_shape: Tuple[int, int] | None = None,
    **kwargs,
) -> nn.Module:
    """Instantiate a registered model on `device`, its weights drawn from
    `generator` when one is given (else torch's global RNG). `image_shape`
    (H, W) reaches the models whose layers depend on it and is ignored by
    the others. A model of the JAX package that is not ported yet raises
    NotImplementedError."""
    if name in NOT_PORTED and name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md slice {NOT_PORTED[name]})")
    if name not in MODEL_REGISTRY:
        known = ", ".join(sorted(MODEL_REGISTRY))
        raise KeyError(f"Unknown model '{name}'. Registered models: {known}")
    device = resolve_device(device)
    if image_shape is not None and name in _TAKES_IMAGE_SHAPE:
        kwargs["image_shape"] = tuple(image_shape)
    model = MODEL_REGISTRY[name](**kwargs)
    if generator is not None:
        model.reset_parameters(generator)
    return model.to(device)
