"""Plain PyTorch reference of BtsModel with a DenseNet-161 encoder.

BTS (Lee et al., arXiv:1907.10326): the DenseNet-161 encoder, the dilated
ASPP (3, 6, 12, 18, 24), local planar guidance at 8x, 4x and 2x, and
max_depth * sigmoid as the final depth; plain `torch.nn` layers under the
program's state-dict names.

`build(kwargs, image_shape)` takes the keyword arguments the
configuration gives the program's model of this name. The module returns
its outputs as a list whose last entry is the final depth [B, 1, H, W],
as the program's model does.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _bn(channels: int, eps: float = 1e-5) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps)



BLOCKS, GROWTH, INIT, BN_SIZE = (6, 12, 36, 24), 48, 96, 4
FEAT = (96, 96, 192, 384, 2208)


def _pconv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
           bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, dilation * (kernel - 1) // 2,
                     dilation=dilation, bias=bias)


def _dbn(channels: int) -> nn.BatchNorm2d:
    """The decoder's BatchNorm (epsilon 1.1e-5)."""
    return nn.BatchNorm2d(channels, eps=1.1e-5)


class DenseLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.norm1 = _bn(cin)
        self.conv1 = _pconv(cin, BN_SIZE * GROWTH, 1)
        self.norm2 = _bn(BN_SIZE * GROWTH)
        self.conv2 = _pconv(BN_SIZE * GROWTH, GROWTH, 3)

    def forward(self, x):
        out = self.conv1(torch.relu(self.norm1(x)))
        out = self.conv2(torch.relu(self.norm2(out)))
        return torch.cat([x, out], 1)


class DenseNet161(nn.Module):
    def __init__(self):
        super().__init__()
        layers = OrderedDict([("conv0", _pconv(3, INIT, 7, 2)), ("norm0", _bn(INIT)),
                              ("relu0", nn.ReLU()), ("pool0", nn.MaxPool2d(3, 2, 1))])
        channels = INIT
        for i, count in enumerate(BLOCKS):
            layers[f"denseblock{i + 1}"] = nn.Sequential(OrderedDict(
                (f"denselayer{j + 1}", DenseLayer(channels + j * GROWTH))
                for j in range(count)))
            channels += count * GROWTH
            if i < 3:
                layers[f"transition{i + 1}"] = nn.Sequential(OrderedDict([
                    ("norm", _bn(channels)), ("relu", nn.ReLU()),
                    ("conv", _pconv(channels, channels // 2, 1)),
                    ("pool", nn.AvgPool2d(2, 2))]))
                channels //= 2
        layers["norm5"] = _bn(channels)
        self.base_model = nn.Sequential(layers)

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        for name, module in self.base_model.named_children():
            x = module(x)
            if name in ("relu0", "pool0", "transition1", "transition2", "norm5"):
                feats.append(x)
        return feats


class AtrousConv(nn.Module):
    def __init__(self, cin: int, cout: int, dilation: int, bn_first: bool = True):
        super().__init__()
        layers = OrderedDict()
        if bn_first:
            layers["first_bn"] = _dbn(cin)
        layers["aconv_sequence"] = nn.Sequential(
            nn.ReLU(), _pconv(cin, 2 * cout, 1), _bn(2 * cout), nn.ReLU(),
            _pconv(2 * cout, cout, 3, dilation=dilation))
        self.atrous_conv = nn.Sequential(layers)

    def forward(self, x):
        return self.atrous_conv(x)


class UpConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _pconv(cin, cout, 3)

    def forward(self, x):
        return F.elu(self.conv(F.interpolate(x, scale_factor=2, mode="nearest")))


class Reduction1x1(nn.Module):
    """1x1 + ELU reductions down to the plane parameters (unit normal and
    distance, [B, 4, h, w]) or, final, one sigmoid channel."""

    def __init__(self, cin: int, cout: int, max_depth: float, is_final: bool = False):
        super().__init__()
        self.max_depth, self.is_final = max_depth, is_final
        reduc = OrderedDict()
        while cout >= 4:
            if cout < 8:
                if is_final:
                    reduc["final"] = nn.Sequential(_pconv(cin, 1, 1), nn.Sigmoid())
                else:
                    reduc["plane_params"] = _pconv(cin, 3, 1)
                break
            reduc[f"inter_{cin}_{cout}"] = nn.Sequential(_pconv(cin, cout, 1), nn.ELU())
            cin, cout = cout, cout // 2
        self.reduc = nn.Sequential(reduc)

    def forward(self, x):
        x = self.reduc(x)
        if self.is_final:
            return x
        theta = torch.sigmoid(x[:, 0]) * (math.pi / 3)
        phi = torch.sigmoid(x[:, 1]) * (math.pi * 2)
        dist = torch.sigmoid(x[:, 2]) * self.max_depth
        return torch.stack([torch.sin(theta) * torch.cos(phi),
                            torch.sin(theta) * torch.sin(phi), torch.cos(theta), dist], 1)


def local_planar_guidance(plane: torch.Tensor, ratio: int) -> torch.Tensor:
    """Plane equations [B, 4, h, w] -> depth [B, h*r, w*r]: n4 / (n1 u + n2 v
    + n3) at each fine pixel's offset (u, v) = ((i - (r - 1) / 2) / r)
    inside its coarse cell."""
    full = plane.repeat_interleave(ratio, dim=2).repeat_interleave(ratio, dim=3)
    offsets = (torch.arange(ratio, dtype=plane.dtype, device=plane.device)
               - (ratio - 1) * 0.5) / ratio
    u = offsets.repeat(plane.shape[3])[None, None, :]
    v = offsets.repeat(plane.shape[2])[None, :, None]
    return full[:, 3] / (full[:, 0] * u + full[:, 1] * v + full[:, 2])


def _nearest_down(depth: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest resize to 1/factor: source index floor(i * factor)."""
    return depth[:, :, ::factor, ::factor]


class BtsDecoder(nn.Module):
    def __init__(self, nf: int, max_depth: float):
        super().__init__()
        c = FEAT
        self.max_depth = max_depth
        self.upconv5 = UpConv(c[4], nf)
        self.bn5 = _dbn(nf)
        self.conv5 = nn.Sequential(_pconv(nf + c[3], nf, 3), nn.ELU())
        self.upconv4 = UpConv(nf, nf // 2)
        self.bn4 = _dbn(nf // 2)
        self.conv4 = nn.Sequential(_pconv(nf // 2 + c[2], nf // 2, 3), nn.ELU())
        self.bn4_2 = _dbn(nf // 2)
        self.daspp_3 = AtrousConv(nf // 2, nf // 4, 3, bn_first=False)
        self.daspp_6 = AtrousConv(nf // 2 + nf // 4 + c[2], nf // 4, 6)
        self.daspp_12 = AtrousConv(nf + c[2], nf // 4, 12)
        self.daspp_18 = AtrousConv(nf + nf // 4 + c[2], nf // 4, 18)
        self.daspp_24 = AtrousConv(nf + nf // 2 + c[2], nf // 4, 24)
        self.daspp_conv = nn.Sequential(_pconv(nf + nf // 2 + nf // 4, nf // 4, 3), nn.ELU())
        self.reduc8x8 = Reduction1x1(nf // 4, nf // 4, max_depth)
        self.upconv3 = UpConv(nf // 4, nf // 4)
        self.bn3 = _dbn(nf // 4)
        self.conv3 = nn.Sequential(_pconv(nf // 4 + c[1] + 1, nf // 4, 3), nn.ELU())
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, max_depth)
        self.upconv2 = UpConv(nf // 4, nf // 8)
        self.bn2 = _dbn(nf // 8)
        self.conv2 = nn.Sequential(_pconv(nf // 8 + c[0] + 1, nf // 8, 3), nn.ELU())
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, max_depth)
        self.upconv1 = UpConv(nf // 8, nf // 16)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, max_depth, is_final=True)
        self.conv1 = nn.Sequential(_pconv(nf // 16 + 1 + 3, nf // 16, 3), nn.ELU())
        self.get_depth = nn.Sequential(_pconv(nf // 16, 1, 3), nn.Sigmoid())

    def _plane_depth(self, reduction, feat, ratio: int):
        eq = reduction(feat)
        normal = eq[:, :3]
        normal = normal / torch.linalg.vector_norm(normal, dim=1, keepdim=True).clamp(min=1e-12)
        eq = torch.cat([normal, eq[:, 3:]], 1)
        return local_planar_guidance(eq, ratio)[:, None] / self.max_depth

    def forward(self, features):
        skip0, skip1, skip2, skip3 = features[1:5]
        dense = torch.relu(features[5])
        up5 = self.bn5(self.upconv5(dense))
        iconv5 = self.conv5(torch.cat([up5, skip3], 1))
        up4 = self.bn4(self.upconv4(iconv5))
        concat4 = torch.cat([up4, skip2], 1)
        iconv4 = self.bn4_2(self.conv4(concat4))
        daspp_3 = self.daspp_3(iconv4)
        concat4_2 = torch.cat([concat4, daspp_3], 1)
        daspp_6 = self.daspp_6(concat4_2)
        concat4_3 = torch.cat([concat4_2, daspp_6], 1)
        daspp_12 = self.daspp_12(concat4_3)
        concat4_4 = torch.cat([concat4_3, daspp_12], 1)
        daspp_18 = self.daspp_18(concat4_4)
        concat4_5 = torch.cat([concat4_4, daspp_18], 1)
        daspp_24 = self.daspp_24(concat4_5)
        feat = self.daspp_conv(torch.cat(
            [iconv4, daspp_3, daspp_6, daspp_12, daspp_18, daspp_24], 1))
        depth_8x8 = self._plane_depth(self.reduc8x8, feat, 8)
        up3 = self.bn3(self.upconv3(feat))
        iconv3 = self.conv3(torch.cat([up3, skip1, _nearest_down(depth_8x8, 4)], 1))
        depth_4x4 = self._plane_depth(self.reduc4x4, iconv3, 4)
        up2 = self.bn2(self.upconv2(iconv3))
        iconv2 = self.conv2(torch.cat([up2, skip0, _nearest_down(depth_4x4, 2)], 1))
        depth_2x2 = self._plane_depth(self.reduc2x2, iconv2, 2)
        up1 = self.upconv1(iconv2)
        reduc1x1 = self.reduc1x1(up1)
        iconv1 = self.conv1(torch.cat([up1, reduc1x1, depth_2x2, depth_4x4, depth_8x8], 1))
        return self.max_depth * self.get_depth(iconv1)


class BtsModel(nn.Module):
    """[B, 3, H, W] (H and W multiples of 32) -> [final depth [B, 1, H, W] in
    metres, (0, max_depth)]."""

    def __init__(self, num_features: int = 512, max_depth: float = 80.0):
        super().__init__()
        if num_features // 32 < 4:
            raise ValueError("the reference is written for num_features >= 128")
        self.encoder = DenseNet161()
        self.decoder = BtsDecoder(num_features, max_depth)

    def forward(self, x) -> List[torch.Tensor]:
        return [self.decoder(self.encoder(x))]


def build(kwargs: Dict, image_shape: Tuple[int, int]) -> nn.Module:
    """[B, 3, H, W] (H and W multiples of 32) -> [final depth [B, 1, H, W]]."""
    return BtsModel(**kwargs)
