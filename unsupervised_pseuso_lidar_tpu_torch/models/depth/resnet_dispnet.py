"""DispResNet — ResNet encoder + monodepth2 depth decoder (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/depth/resnet_dispnet.py
(ResnetEncoder :123, DepthDecoder :183, DispResNet :276). Module and
parameter names follow the torch state-dict schema the JAX package exports
(train/checkpoint.py _dispresnet_mapping), so weights.state_dict_from_jax
output loads with strict=True.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    Conv3x3,
    ConvBlock,
    torch_default_init_,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import upsample2x_nearest

# ResNet-18 blocks per stage; the other depths (34/50/101/152) are not
# ported yet
RESNET_STAGE_BLOCKS = {18: (2, 2, 2, 2)}
NUM_CH_ENC = (64, 64, 128, 256, 512)
NUM_CH_DEC = (16, 32, 64, 128, 256)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's running-statistics update in train mode.

    flax BatchNorm(momentum=0.9, epsilon=1e-5) normalizes a training batch
    as torch does, but moves running_var toward the BIASED batch variance
    E[x²] − E[x]² (fp32, clipped at 0), where torch uses the unbiased one
    (a factor n/(n−1): 4 % at 24 values per channel). Here the running
    statistics are updated the flax way — 0.9 · running + 0.1 · batch —
    from the batch in fp32; eval mode is torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + self.momentum * mean)
            self.running_var.copy_(decay * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


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


class _ResNetTrunk(nn.Module):
    """torchvision's ResNet layout without the classifier head."""

    def __init__(self, num_layers: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for stage, num_blocks in enumerate(RESNET_STAGE_BLOCKS[num_layers]):
            width = 64 * 2 ** stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(BasicBlock(in_ch, width, stride))
                in_ch = width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """ResNet feature pyramid: [relu(bn(conv1)), layer1, …, layer4] with
    widths (64, 64, 128, 256, 512)."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers not in RESNET_STAGE_BLOCKS:
            raise ValueError(f"{num_layers} is not a supported resnet depth")
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
    2·(4-i)+j holds upconv(i, j), index 10+s the scale-s head. Only the
    scale-0 head runs in forward (DispResNet returns [disp0]); the others
    keep their parameters so checkpoints load either way."""

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

    def forward(self, features: Sequence[torch.Tensor], image_shape) -> torch.Tensor:
        """-> scale-0 disparity [B, 1, H, W], cropped to `image_shape`."""
        x = features[-1]
        for i in range(4, -1, -1):
            x = self.decoder[2 * (4 - i)](x)
            x = upsample2x_nearest(x)
            if i > 0:
                # crop-to-skip: at non-multiple-of-32 inputs the upsample
                # overshoots the encoder skip by one row/col
                skip = features[i - 1]
                x = torch.cat([x[:, :, : skip.shape[2], : skip.shape[3]], skip], 1)
            x = self.decoder[2 * (4 - i) + 1](x)
        disp = torch.sigmoid(self.decoder[10](x))
        return disp[:, :, : image_shape[0], : image_shape[1]]


class DispResNet(nn.Module):
    """Encoder + decoder; returns [disp0] ([B, 1, H, W]) like the JAX
    model."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = DepthDecoder()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [self.decoder(self.encoder(x), x.shape[2:])]

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
