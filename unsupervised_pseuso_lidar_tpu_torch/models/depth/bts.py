"""BTS ("From Big to Small") metric-depth network — the serving model of
the pseudo-LiDAR pipeline (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/depth/bts.py (_BN :38,
DenseLayer :53, DenseNet161Encoder :69, AtrousConv :115, UpConv :144,
Reduction1x1 :157, local_planar_guidance :193, BtsDecoder :218, BtsModel
:322): a DenseNet-161 encoder, a decoder with the dilated-ASPP stack
(dilations 3/6/12/18/24) and local-planar-guidance heads at 8x, 4x and 2x,
and the final depth 80 · sigmoid. forward(x, focal) returns the 5-tuple
(depth_8x8, depth_4x4, depth_2x2, reduc1x1, final_depth), each
[B, 1, H, W]; focal is accepted and unused, as in the reference.

Module names are the reference's (encoder.base_model.* after torchvision's
densenet161.features, decoder.*), so the reference ROS node's serving blob
loads with strict=True once its DataParallel `module.` prefix is dropped.
Every BatchNorm updates its running statistics by flax's rule in train
mode (layers.BatchNorm2d), with JAX's per-instance epsilon and momentum.

Under a mesh with a "spatial" axis (trainer.bind_spatial) x is a band of
the image's rows, whose height must be a multiple of 32 (row_multiple:
JAX's skip concatenations need it too). Every conv and pool is a
layers.Banded module given its level — the stem at 0, the max-pool at 1,
dense block and transition i at 2 + i, the decoder's stages at 4 down to
0, the ASPP at 3 (its 3x3 convs dilated up to 24 rows, whose halos reach
past short bands) — and the levels whose bands hold no whole row run on
the gathered map (parallel/spatial.banded_level). The nearest upsamples,
the 1x1 reductions and LPG read no row outside their band: LPG's planes
cover whole coarse cells, and a band starts at a multiple of the cell.
Its depth is cut back to the band where the coarse level was whole, and
its nearest downsample to 1/4 or 1/2 picks the image's rows on a band
(which starts at a multiple of the factor) or resizes the whole map
where that level is whole. Each output is this rank's band of the
full-resolution map.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    Banded,
    BatchNorm2d,
    MaxPool2d,
    avg_pool,
    conv,
    init_module_,
    lecun_normal_,
    set_image_height,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import (
    resize_nearest,
    upsample2x_nearest,
)
from unsupervised_pseuso_lidar_tpu_torch.parallel import spatial

DENSENET161_BLOCKS = (6, 12, 36, 24)
DENSENET161_GROWTH = 48
DENSENET161_INIT = 96
BN_SIZE = 4
# widths of the encoder's skip features relu0, pool0, transition1,
# transition2 and norm5
FEAT_OUT_CHANNELS = (96, 96, 192, 384, 2208)
# the levels (the image's 2**level times smaller map) of the first dense
# block and of the ASPP
DENSE_LEVEL, ASPP_LEVEL = 2, 3


def _bn(channels: int, eps: float = 1.1e-5, momentum: float = 0.01) -> BatchNorm2d:
    """JAX's _BN: momentum in torch's convention; the decoder's default
    (eps 1.1e-5, momentum 0.01)."""
    return BatchNorm2d(channels, eps=eps, momentum=momentum)


def _encoder_bn(channels: int) -> BatchNorm2d:
    return _bn(channels, eps=1e-5, momentum=0.1)


class DenseLayer(nn.Module):
    """torchvision's DenseLayer: BN-ReLU-1x1 -> BN-ReLU-3x3, the input
    concatenated before the new features; at `level`."""

    def __init__(self, in_channels: int, growth: int = DENSENET161_GROWTH, level=None):
        super().__init__()
        self.norm1 = _encoder_bn(in_channels)
        self.conv1 = conv(in_channels, BN_SIZE * growth, 1, bias=False, level=level)
        self.norm2 = _encoder_bn(BN_SIZE * growth)
        self.conv2 = conv(BN_SIZE * growth, growth, 3, bias=False, level=level)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(torch.relu(self.norm1(x)))
        out = self.conv2(torch.relu(self.norm2(out)))
        return torch.cat([x, out], 1)


class _Transition(nn.Sequential):
    """BN-ReLU-1x1 (half the width)-avgpool2; its input at `level`."""

    def __init__(self, in_channels: int, out_channels: int, level=None):
        super().__init__(OrderedDict([
            ("norm", _encoder_bn(in_channels)), ("relu", nn.ReLU()),
            ("conv", conv(in_channels, out_channels, 1, bias=False, level=level)),
            ("pool", avg_pool(level)),
        ]))


class DenseNet161Encoder(nn.Module):
    """DenseNet-161 feature pyramid -> [input, relu0, pool0, transition1,
    transition2, norm5], widths (3, 96, 96, 192, 384, 2208) at strides (1,
    2, 4, 8, 16, 32); norm5 before its ReLU (the decoder applies it)."""

    def __init__(self):
        super().__init__()
        pool0 = MaxPool2d(3, 2, 1)
        pool0.level = 1
        layers = OrderedDict([
            ("conv0", conv(3, DENSENET161_INIT, 7, stride=2, bias=False, level=0)),
            ("norm0", _encoder_bn(DENSENET161_INIT)),
            ("relu0", nn.ReLU()),
            ("pool0", pool0),
        ])
        channels = DENSENET161_INIT
        for i, num_layers in enumerate(DENSENET161_BLOCKS):
            level = DENSE_LEVEL + i
            block = nn.Sequential(OrderedDict(
                (f"denselayer{l + 1}",
                 DenseLayer(channels + l * DENSENET161_GROWTH, level=level))
                for l in range(num_layers)))
            layers[f"denseblock{i + 1}"] = block
            channels += num_layers * DENSENET161_GROWTH
            if i < 3:
                layers[f"transition{i + 1}"] = _Transition(channels, channels // 2, level)
                channels //= 2
        layers["norm5"] = _encoder_bn(channels)
        self.base_model = nn.Sequential(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        for name, module in self.base_model.named_children():
            x = module(x)
            if name in ("relu0", "pool0", "transition1", "transition2", "norm5"):
                feats.append(x)
        return feats


class AtrousConv(nn.Module):
    """[BN] -> ReLU -> 1x1 (2c) -> BN -> ReLU -> 3x3 dilated (c), under the
    reference's atrous_conv.{first_bn, aconv_sequence.*} names; at the
    ASPP's level."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int,
                 apply_bn_first: bool = True):
        super().__init__()
        layers = OrderedDict()
        if apply_bn_first:
            layers["first_bn"] = _bn(in_channels)
        layers["aconv_sequence"] = nn.Sequential(
            nn.ReLU(),
            conv(in_channels, 2 * out_channels, 1, bias=False, level=ASPP_LEVEL),
            _bn(2 * out_channels, eps=1e-5, momentum=0.01),
            nn.ReLU(),
            conv(2 * out_channels, out_channels, 3, bias=False, level=ASPP_LEVEL,
                 dilation=dilation),
        )
        self.atrous_conv = nn.Sequential(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.atrous_conv(x)


class UpConv(Banded, nn.Module):
    """Nearest 2x upsample -> 3x3 conv (no bias) -> ELU; its output at
    `level`, in that level's placement (parallel/spatial.placed)."""

    def __init__(self, in_channels: int, out_channels: int, level=None):
        super().__init__()
        self.level = level
        self.conv = conv(in_channels, out_channels, 3, bias=False, level=level)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = spatial.placed(upsample2x_nearest(x), self.mesh, self.height, self.level)
        return F.elu(self.conv(up))


class Reduction1x1(nn.Module):
    """A cascade of 1x1 + ELU reductions ending in the plane parameters
    (θ, φ, distance -> unit normal and distance, [B, 4, h, w]) or, with
    is_final, one sigmoid channel."""

    def __init__(self, in_channels: int, out_channels: int, max_depth: float,
                 is_final: bool = False, level=None):
        super().__init__()
        self.max_depth, self.is_final = max_depth, is_final
        reduc = OrderedDict()
        while out_channels >= 4:
            if out_channels < 8:
                if is_final:
                    reduc["final"] = nn.Sequential(
                        conv(in_channels, 1, 1, bias=False, level=level), nn.Sigmoid())
                else:
                    reduc["plane_params"] = conv(in_channels, 3, 1, bias=False, level=level)
                break
            reduc[f"inter_{in_channels}_{out_channels}"] = nn.Sequential(
                conv(in_channels, out_channels, 1, bias=False, level=level), nn.ELU())
            in_channels, out_channels = out_channels, out_channels // 2
        self.reduc = nn.Sequential(reduc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.reduc(x)
        if self.is_final:
            return x
        theta = torch.sigmoid(x[:, 0]) * (math.pi / 3)
        phi = torch.sigmoid(x[:, 1]) * (math.pi * 2)
        dist = torch.sigmoid(x[:, 2]) * self.max_depth
        n1 = torch.sin(theta) * torch.cos(phi)
        n2 = torch.sin(theta) * torch.sin(phi)
        n3 = torch.cos(theta)
        return torch.stack([n1, n2, n3, dist], dim=1)


def local_planar_guidance(plane_eq: torch.Tensor, upratio: int) -> torch.Tensor:
    """Coarse plane equations [B, 4, h, w] -> depth [B, h·r, w·r]:
    n4 / (n1·u + n2·v + n3) at each fine pixel's offsets (u, v) =
    ((i − (r − 1)/2) / r) inside its coarse cell (JAX's order of
    operations)."""
    batch, _, height, width = plane_eq.shape
    r = upratio
    exp = plane_eq[:, :, :, None, :, None].expand(batch, 4, height, r, width, r)
    exp = exp.reshape(batch, 4, height * r, width * r)
    offsets = (torch.arange(r, dtype=plane_eq.dtype, device=plane_eq.device)
               - (r - 1) * 0.5) / r
    u = offsets.repeat(width)[None, None, :]
    v = offsets.repeat(height)[None, :, None]
    denom = exp[:, 0] * u + exp[:, 1] * v + exp[:, 2]
    return exp[:, 3] / denom


class BtsDecoder(Banded, nn.Module):
    """The upconv ladder, the dilated ASPP and the LPG heads; stage i at
    level i (its input at i + 1), the ASPP at ASPP_LEVEL."""

    def __init__(self, num_features: int = 512, max_depth: float = 80.0,
                 feat_out_channels: Sequence[int] = FEAT_OUT_CHANNELS):
        super().__init__()
        nf, c = num_features, feat_out_channels
        self.max_depth = max_depth
        self.upconv5 = UpConv(c[4], nf, 4)
        self.bn5 = _bn(nf)
        self.conv5 = nn.Sequential(conv(nf + c[3], nf, 3, bias=False, level=4), nn.ELU())
        self.upconv4 = UpConv(nf, nf // 2, 3)
        self.bn4 = _bn(nf // 2)
        self.conv4 = nn.Sequential(conv(nf // 2 + c[2], nf // 2, 3, bias=False, level=3),
                                   nn.ELU())
        self.bn4_2 = _bn(nf // 2)
        self.daspp_3 = AtrousConv(nf // 2, nf // 4, 3, apply_bn_first=False)
        self.daspp_6 = AtrousConv(nf // 2 + nf // 4 + c[2], nf // 4, 6)
        self.daspp_12 = AtrousConv(nf + c[2], nf // 4, 12)
        self.daspp_18 = AtrousConv(nf + nf // 4 + c[2], nf // 4, 18)
        self.daspp_24 = AtrousConv(nf + nf // 2 + c[2], nf // 4, 24)
        self.daspp_conv = nn.Sequential(
            conv(nf + nf // 2 + nf // 4, nf // 4, 3, bias=False, level=ASPP_LEVEL), nn.ELU())
        self.reduc8x8 = Reduction1x1(nf // 4, nf // 4, max_depth, level=ASPP_LEVEL)
        self.upconv3 = UpConv(nf // 4, nf // 4, 2)
        self.bn3 = _bn(nf // 4)
        self.conv3 = nn.Sequential(conv(nf // 4 + c[1] + 1, nf // 4, 3, bias=False, level=2),
                                   nn.ELU())
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, max_depth, level=2)
        self.upconv2 = UpConv(nf // 4, nf // 8, 1)
        self.bn2 = _bn(nf // 8)
        self.conv2 = nn.Sequential(conv(nf // 8 + c[0] + 1, nf // 8, 3, bias=False, level=1),
                                   nn.ELU())
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, max_depth, level=1)
        self.upconv1 = UpConv(nf // 8, nf // 16, 0)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, max_depth, is_final=True, level=0)
        self.conv1 = nn.Sequential(conv(nf // 16 + 4, nf // 16, 3, bias=False, level=0),
                                   nn.ELU())
        self.get_depth = nn.Sequential(conv(nf // 16, 1, 3, bias=False, level=0),
                                       nn.Sigmoid())

    def _plane_depth(self, reduction: Reduction1x1, feat: torch.Tensor,
                     level: int) -> torch.Tensor:
        """The plane head of a level-`level` map -> its full-resolution
        depth (LPG at 2**level), in level 0's placement: this rank's band,
        cut out of the whole map where `level` is whole."""
        eq = reduction(feat)
        normal = eq[:, :3]
        normal = normal / torch.linalg.vector_norm(normal, dim=1, keepdim=True).clamp(min=1e-12)
        eq = torch.cat([normal, eq[:, 3:]], 1)
        depth = local_planar_guidance(eq, 2 ** level)[:, None] / self.max_depth
        if spatial.row_sharded(self.mesh) and not self.on_bands(level):
            depth = spatial.cut_band(depth, self.mesh, self.height)
        return depth

    def _downsampled(self, depth: torch.Tensor, level: int) -> torch.Tensor:
        """JAX's resize_nearest of a full-resolution depth [B, 1, R, W] to
        level `level` (R // 2**level rows), in that level's placement: on
        a band, which starts at a multiple of 2**level, the source rows
        floor(i · 2**level) are the whole map's; where the level is whole,
        from the whole map (gathered with its gradient)."""
        if spatial.row_sharded(self.mesh) and not self.on_bands(level):
            depth = spatial.gather_band(depth, self.mesh, self.height)
        factor = 2 ** level
        return resize_nearest(depth, depth.shape[2] // factor, depth.shape[3] // factor)

    def forward(self, features: Sequence[torch.Tensor], focal=None
                ) -> Tuple[torch.Tensor, ...]:
        skip0, skip1, skip2, skip3 = features[1:5]
        dense_features = torch.relu(features[5])

        up5 = self.bn5(self.upconv5(dense_features))  # H/16
        iconv5 = self.conv5(torch.cat([up5, skip3], 1))
        up4 = self.bn4(self.upconv4(iconv5))  # H/8
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
        daspp_feat = self.daspp_conv(torch.cat(
            [iconv4, daspp_3, daspp_6, daspp_12, daspp_18, daspp_24], 1))

        depth_8x8 = self._plane_depth(self.reduc8x8, daspp_feat, ASPP_LEVEL)  # full res
        d8_ds = self._downsampled(depth_8x8, 2)
        up3 = self.bn3(self.upconv3(daspp_feat))  # H/4
        iconv3 = self.conv3(torch.cat([up3, skip1, d8_ds], 1))

        depth_4x4 = self._plane_depth(self.reduc4x4, iconv3, 2)
        d4_ds = self._downsampled(depth_4x4, 1)
        up2 = self.bn2(self.upconv2(iconv3))  # H/2
        iconv2 = self.conv2(torch.cat([up2, skip0, d4_ds], 1))

        depth_2x2 = self._plane_depth(self.reduc2x2, iconv2, 1)
        up1 = self.upconv1(iconv2)  # H
        reduc1x1 = self.reduc1x1(up1)
        iconv1 = self.conv1(torch.cat([up1, reduc1x1, depth_2x2, depth_4x4, depth_8x8], 1))
        final_depth = self.max_depth * self.get_depth(iconv1)
        return depth_8x8, depth_4x4, depth_2x2, reduc1x1, final_depth


class BtsModel(Banded, nn.Module):
    """DenseNet-161 encoder + BTS decoder. The training step takes its five
    outputs as five "disparities", every one at full resolution (JAX's
    forward_batch): `scales`."""

    scales = (0,) * 5
    # under a spatial mesh the height must be a multiple of this: the
    # decoder concatenates the 2x upsample of the 1/32 map with the 1/16
    # skip, which JAX's model needs too (parallel/spatial.check_height)
    row_multiple = 32

    def __init__(self, num_features: int = 512, max_depth: float = 80.0):
        super().__init__()
        self.encoder = DenseNet161Encoder()
        self.decoder = BtsDecoder(num_features, max_depth)

    def forward(self, x: torch.Tensor, focal=None, height: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
        """x: the images, or under a spatial mesh this rank's band of the
        rows of images `height` rows tall."""
        set_image_height(self, x, height)
        return self.decoder(self.encoder(x), focal)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX model's distributions: torch-default
        convs, lecun-normal dilated convs (flax nn.Conv), unit/zero
        BatchNorm."""
        init_module_(self, generator)
        for m in self.modules():
            if isinstance(m, AtrousConv):
                lecun_normal_(m.atrous_conv.aconv_sequence[4].weight, generator)
