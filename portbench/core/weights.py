"""Seeded weights, made on the device in one draw and filled by name.

Both sides of a comparison get their weights from `fill(modules, seed,
init)`: the program's modules and the plain reference's, which share
their parameter names. Every convolution and Linear weight, and bias,
takes its slice of ONE standard-normal draw of a `torch.Generator` on the
modules' device, in the sorted order of the qualified names, scaled by its
own standard deviation:

- a weight: gain / sqrt(fan_in), fan_in = weight[0].numel() (He-normal
  at the default gain sqrt(2));
- a bias: bias_gain / sqrt(fan_in) of its layer;
- a name listed under `init["std"]` takes that standard deviation
  instead (PoseFc's last Linear: a small translation, so that the warp
  starts near, not at, the identity, where the loss's gradient is
  chaotic).

BatchNorm layers start at unit scale, zero shift, running mean 0 and
running variance 1. So the same seed gives the same weights to every
module tree with these names, on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

DEFAULT_INIT = {"gain": math.sqrt(2.0), "bias_gain": 0.5, "std": {}}


def _layers(modules: Dict[str, nn.Module]) -> List[Tuple[str, nn.Module]]:
    out = []
    for prefix, root in modules.items():
        for name, module in root.named_modules():
            out.append((f"{prefix}.{name}" if name else prefix, module))
    return out


def fill(modules: Dict[str, nn.Module], seed: int, init: Dict | None = None) -> None:
    """Fill every parameter and BatchNorm buffer of `modules` ({prefix:
    module}, all on one device) from `seed` (module docstring)."""
    init = {**DEFAULT_INIT, **(init or {})}
    overrides = init.get("std", {})
    targets = []  # (qualified name, tensor, std)
    device = None
    with torch.no_grad():
        for name, module in _layers(modules):
            if isinstance(module, nn.modules.batchnorm._BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
                module.num_batches_tracked.zero_()
            elif isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                targets.append((f"{name}.weight", module.weight,
                                init["gain"] / math.sqrt(fan_in)))
                if module.bias is not None:
                    targets.append((f"{name}.bias", module.bias,
                                    init["bias_gain"] / math.sqrt(fan_in)))
        unknown = set(overrides) - {t[0] for t in targets}
        if unknown:
            raise KeyError(f"init std names no parameter: {sorted(unknown)}")
        targets.sort(key=lambda t: t[0])
        if not targets:
            return
        device = targets[0][1].device
        total = sum(t.numel() for _, t, _ in targets)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        draw = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
        offset = 0
        for name, tensor, std in targets:
            n = tensor.numel()
            tensor.copy_(draw[offset:offset + n].view_as(tensor) * overrides.get(name, std))
            offset += n

