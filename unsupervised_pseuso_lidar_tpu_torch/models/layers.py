"""Shared conv building blocks (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/layers.py, ported for
its semantics only: Conv3x3 = reflection pad 1 + 3x3 conv, ConvBlock =
Conv3x3 + ELU, and strided convs with torch's symmetric (k-1)//2 padding
(nn.Conv2d's own). The TPU layout rewrites there (space-to-depth stem,
pre_upsample2x phase convs, s2d_tail / s2d_domain, border-ring convs)
compute the same function with the same parameters and have no
counterpart here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import reflect_pad1


class Conv3x3(nn.Module):
    """Reflection-pad-1 + 3x3 conv (parameters under ``.conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    """Conv3x3 (reflect pad) + ELU (parameters under ``.conv.conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


def torch_default_init_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """torch's default conv init — kernel and bias from U(±1/sqrt(fan_in))
    — drawn from `generator`."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)
