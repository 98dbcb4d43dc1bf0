"""Plain PyTorch reference of DispResNet with a ResNet-18 encoder.

monodepth2's ResNet-18 encoder and depth decoder (nearest 2x upsample,
skip concatenation, reflection-padded 3x3 convs, ELU, sigmoid disparity
head at scale 0), written with plain `torch.nn` layers: no kernel, no CUDA
graph, no banding. Module and parameter names are the program's
state-dict names, so the benchmark's seeded weights fill both sides
through the same names (`portbench.core.weights`). BatchNorm is
`nn.BatchNorm2d`; in train mode it normalizes with the batch's
statistics, which is all a training step's loss and gradient read.

`build(kwargs, image_shape)` takes the keyword arguments the
configuration gives the program's model of this name.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NUM_CH_ENC = (64, 64, 128, 256, 512)
NUM_CH_DEC = (16, 32, 64, 128, 256)


def _bn(channels: int, eps: float = 1e-5) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.bn1 = _bn(cout)
        self.conv2 = _conv(cout, cout, 3)
        self.bn2 = _bn(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class _Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        cin = 64
        for stage in range(4):
            width = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock(cin, width, stride), BasicBlock(width, width)))
            cin = width


class ResnetEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _Trunk()

    def forward(self, x) -> List[torch.Tensor]:
        e = self.encoder
        out = torch.relu(e.bn1(e.conv1(x)))
        features = [out]
        out = F.max_pool2d(out, 3, 2, 1)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            out = layer(out)
            features.append(out)
        return features


class Conv3x3(nn.Module):
    """Reflection pad 1, then a 3x3 conv with bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        blocks = []
        for i in range(4, -1, -1):
            cin = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i] + (NUM_CH_ENC[i - 1] if i > 0 else 0)
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i]))
        heads = [Conv3x3(NUM_CH_DEC[s], 1) for s in range(4)]
        self.decoder = nn.ModuleList(blocks + heads)

    def forward(self, features, image_shape) -> List[torch.Tensor]:
        x = features[-1]
        for i in range(4, -1, -1):
            x = self.decoder[2 * (4 - i)](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                skip = features[i - 1]
                x = torch.cat([x[:, :, : skip.shape[2], : skip.shape[3]], skip], 1)
            x = self.decoder[2 * (4 - i) + 1](x)
        disp = torch.sigmoid(self.decoder[10](x))
        return [disp[:, :, : image_shape[0], : image_shape[1]]]


class DispResNet18(nn.Module):
    """[B, 3, H, W] -> [disparity [B, 1, H, W]] in (0, 1)."""

    def __init__(self):
        super().__init__()
        self.encoder = ResnetEncoder()
        self.decoder = DepthDecoder()

    def forward(self, x) -> List[torch.Tensor]:
        return self.decoder(self.encoder(x), x.shape[2:])


def build(kwargs: Dict, image_shape: Tuple[int, int]) -> nn.Module:
    """[B, 3, H, W] -> [disparity [B, 1, H, W]] (scale 0 only)."""
    if kwargs.get("num_layers", 18) != 18 or kwargs.get("all_scales", False):
        raise NotImplementedError("the reference is DispResNet-18 at scale 0: "
                                  f"the configuration asks for {kwargs}")
    return DispResNet18()
