"""DispResNet — ResNet encoder + monodepth2 depth decoder (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/depth/resnet_dispnet.py
(BasicBlock :50, Bottleneck :84, ResnetEncoder :123, DepthDecoder :183,
DispResNet :276) at every depth there: 18 and 34 of basic blocks, 50, 101
and 152 of bottleneck blocks (4x channel expansion). Module and
parameter names follow the torch state-dict schema the JAX package exports
(train/checkpoint.py _dispresnet_mapping), so weights.state_dict_from_jax
output loads with strict=True.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv3x3,
    ConvBlock,
    torch_default_init_,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import upsample2x_nearest

# blocks per stage, by depth
RESNET_STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
# the depths built of Bottleneck blocks
BOTTLENECK_DEPTHS = frozenset({50, 101, 152})
NUM_CH_DEC = (16, 32, 64, 128, 256)


def num_ch_enc(num_layers: int) -> tuple:
    """Widths of the encoder's five feature maps."""
    if num_layers in BOTTLENECK_DEPTHS:
        return (64, 256, 512, 1024, 2048)
    return (64, 64, 128, 256, 512)


def _bn(channels: int) -> BatchNorm2d:
    # flax BatchNorm(momentum=0.9, epsilon=1e-5) == torch momentum 0.1
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """ResNet v1 basic block: 3x3 conv-bn-relu, 3x3 conv-bn, skip, relu."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, 1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = _bn(channels)
        self.downsample = None
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, channels, 1, stride, bias=False),
                _bn(channels),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """ResNet bottleneck block (torchvision v1.5: the stride on the 3x3):
    1x1 conv-bn-relu, 3x3 conv-bn-relu, 1x1 (4x width) conv-bn, projected
    skip, relu. Output channels = 4 · channels."""

    expansion = 4

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        out_ch = self.expansion * channels
        self.conv1 = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride, 1, bias=False)
        self.bn2 = _bn(channels)
        self.conv3 = nn.Conv2d(channels, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.downsample = None
        if stride != 1 or in_channels != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_ch, 1, stride, bias=False),
                _bn(out_ch),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class _ResNetTrunk(nn.Module):
    """torchvision's ResNet layout without the classifier head."""

    def __init__(self, num_layers: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        bottleneck = num_layers in BOTTLENECK_DEPTHS
        block_cls = Bottleneck if bottleneck else BasicBlock
        in_ch = 64
        for stage, num_blocks in enumerate(RESNET_STAGE_BLOCKS[num_layers]):
            width = 64 * 2 ** stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(block_cls(in_ch, width, stride))
                in_ch = width * (Bottleneck.expansion if bottleneck else 1)
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """ResNet feature pyramid: [relu(bn(conv1)), layer1, …, layer4] with
    widths num_ch_enc(num_layers)."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers not in RESNET_STAGE_BLOCKS:
            raise ValueError(f"{num_layers} is not a supported resnet depth")
        self.num_ch_enc = num_ch_enc(num_layers)
        self.encoder = _ResNetTrunk(num_layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        e = self.encoder
        out = e.relu(e.bn1(e.conv1(x)))
        features = [out]
        out = e.maxpool(out)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            out = layer(out)
            features.append(out)
        return features


class DepthDecoder(nn.Module):
    """monodepth2 decoder: nearest-upsample + skip-concat ConvBlocks and a
    sigmoid disparity head per scale.

    ``decoder`` is the flat ModuleList of the torch schema: index
    2·(4-i)+j holds upconv(i, j), index 10+s the scale-s head. The heads
    of `scales` run in forward; every head keeps its parameters so
    checkpoints load either way."""

    def __init__(self, num_ch_enc: Sequence[int] = num_ch_enc(18)):
        super().__init__()
        blocks = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i]))
        heads = [Conv3x3(NUM_CH_DEC[s], 1) for s in range(4)]
        self.decoder = nn.ModuleList(blocks + heads)

    def forward(self, features: Sequence[torch.Tensor], image_shape,
                scales: Sequence[int] = (0,)) -> List[torch.Tensor]:
        """-> the disparities [B, 1, ceil(H/2^s), ceil(W/2^s)] of `scales`,
        finest first, each cropped to its pyramid size of `image_shape`."""
        x = features[-1]
        outputs = {}
        for i in range(4, -1, -1):
            x = self.decoder[2 * (4 - i)](x)
            x = upsample2x_nearest(x)
            if i > 0:
                # crop-to-skip: at non-multiple-of-32 inputs the upsample
                # overshoots the encoder skip by one row/col
                skip = features[i - 1]
                x = torch.cat([x[:, :, : skip.shape[2], : skip.shape[3]], skip], 1)
            x = self.decoder[2 * (4 - i) + 1](x)
            if i in scales:
                disp = torch.sigmoid(self.decoder[10 + i](x))
                h = -(-image_shape[0] // 2 ** i)
                w = -(-image_shape[1] // 2 ** i)
                outputs[i] = disp[:, :, :h, :w]
        return [outputs[s] for s in sorted(outputs)]


class DispResNet(nn.Module):
    """Encoder + decoder; returns [disp0] ([B, 1, H, W]) like the JAX
    model, or with all_scales the disparities of scales 0-3, finest
    first."""

    def __init__(self, num_layers: int = 18, all_scales: bool = False):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = DepthDecoder(self.encoder.num_ch_enc)
        self.scales = (0, 1, 2, 3) if all_scales else (0,)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.decoder(self.encoder(x), x.shape[2:], self.scales)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX model's distributions: kaiming-normal
        (fan_out, relu) encoder convs, unit/zero BatchNorm, torch-default
        decoder convs."""
        with torch.no_grad():
            for m in self.encoder.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                     generator=generator)
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
            for m in self.decoder.modules():
                if isinstance(m, nn.Conv2d):
                    torch_default_init_(m, generator)
