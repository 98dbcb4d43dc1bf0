"""Model FLOPs counted from shapes on the benchmark's own reference model.

`forward_macs(build, *inputs)` builds a model with `build()` on the meta
device and runs it there (shapes only, no weights and no arithmetic)
with a forward hook on every convolution, transposed convolution and
Linear layer, and sums their multiply-accumulates:

- Conv2d: output elements x (in_channels / groups) x kernel height x
  kernel width;
- ConvTranspose2d: input elements x (out_channels / groups) x kernel
  height x kernel width;
- Linear: output elements x in_features.

A FLOP is 2 MACs. Nothing else (norms, activations, the loss, the warp)
is counted: the model-FLOPs convention of MFU.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def _macs(module: nn.Module, inputs, output) -> int:
    if isinstance(module, nn.Conv2d):
        k = module.kernel_size[0] * module.kernel_size[1]
        return output.numel() * (module.in_channels // module.groups) * k
    if isinstance(module, nn.ConvTranspose2d):
        k = module.kernel_size[0] * module.kernel_size[1]
        return inputs[0].numel() * (module.out_channels // module.groups) * k
    if isinstance(module, nn.Linear):
        return output.numel() * module.in_features
    return 0


def forward_macs(build: Callable[[], nn.Module], *inputs) -> int:
    """MACs of one forward of the model `build()` makes, on inputs of these
    shapes (tuples of sizes, or lists of them for a list argument)."""
    with torch.device("meta"):
        meta = build()
    total = [0]
    handles = [m.register_forward_hook(lambda mod, inp, out: total.__setitem__(
        0, total[0] + _macs(mod, inp, out)))
        for m in meta.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        with torch.no_grad():
            meta(*[[torch.empty(x, device="meta") for x in t] if isinstance(t, list)
                   else torch.empty(t, device="meta") for t in inputs])
    finally:
        for h in handles:
            h.remove()
    return total[0]
