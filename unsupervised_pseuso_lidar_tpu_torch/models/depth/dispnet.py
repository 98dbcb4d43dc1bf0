"""DispNetS — SfMLearner's 7-down / 7-up disparity network (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/depth/dispnet.py
(DispNetS :31): seven DownsampleConvBN encoder blocks, seven transposed-
conv decoder stages with skip concatenations, each cropped to its skip
(crop_like, so any input size works), and four disparity heads
alpha · sigmoid + beta (10, 0.01) whose coarse outputs are bilinearly
upsampled into the next stage. Module names are the reference's
(conv{1-7}, upconv{1-7}.0, iconv{1-7}.0, predict_disp{1-4}.0).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    DownsampleConvBN,
    conv,
    conv_transpose,
    init_module_,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear

CONV_PLANES = (32, 64, 128, 256, 512, 512, 512)
UPCONV_PLANES = (512, 512, 256, 128, 64, 32, 16)
KERNELS = (7, 5, 3, 3, 3, 3, 3)


def _crop_like(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return a[:, :, : ref.shape[2], : ref.shape[3]]


class DispNetS(nn.Module):
    """Returns [disp1, disp2, disp3, disp4], [B, 1, H/2^s, W/2^s], finest
    first."""

    def __init__(self, alpha: float = 10.0, beta: float = 0.01):
        super().__init__()
        self.alpha, self.beta = alpha, beta
        cin = 3
        for i, (planes, k) in enumerate(zip(CONV_PLANES, KERNELS)):
            setattr(self, f"conv{i + 1}", DownsampleConvBN(cin, planes, k))
            cin = planes
        up_in = (CONV_PLANES[6],) + UPCONV_PLANES[:6]
        # iconv{7-1}'s input: the upconv output, the encoder skip, and from
        # iconv3 on the upsampled coarser disparity
        skips = CONV_PLANES[5::-1] + (0,)
        for j, planes in enumerate(UPCONV_PLANES):
            level = 7 - j
            setattr(self, f"upconv{level}",
                    nn.Sequential(conv_transpose(up_in[j], planes), nn.ReLU()))
            cin = planes + skips[j] + (1 if level <= 3 else 0)
            setattr(self, f"iconv{level}", nn.Sequential(conv(cin, planes, 3), nn.ReLU()))
        for s, planes in zip((4, 3, 2, 1), UPCONV_PLANES[3:]):
            setattr(self, f"predict_disp{s}",
                    nn.Sequential(conv(planes, 1, 3), nn.Sigmoid()))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        encoder = []
        out = x
        for i in range(7):
            out = getattr(self, f"conv{i + 1}")(out)
            encoder.append(out)

        def stage(level, inp, like, *extra):
            up = _crop_like(getattr(self, f"upconv{level}")(inp), like)
            return getattr(self, f"iconv{level}")(torch.cat([up, *extra], 1))

        def disp(level, inp):
            return self.alpha * getattr(self, f"predict_disp{level}")(inp) + self.beta

        def up2(d, like):
            return _crop_like(resize_bilinear(d, d.shape[2] * 2, d.shape[3] * 2), like)

        out7 = stage(7, encoder[6], encoder[5], encoder[5])
        out6 = stage(6, out7, encoder[4], encoder[4])
        out5 = stage(5, out6, encoder[3], encoder[3])
        out4 = stage(4, out5, encoder[2], encoder[2])
        disp4 = disp(4, out4)
        out3 = stage(3, out4, encoder[1], encoder[1], up2(disp4, encoder[1]))
        disp3 = disp(3, out3)
        out2 = stage(2, out3, encoder[0], encoder[0], up2(disp3, encoder[0]))
        disp2 = disp(2, out2)
        out1 = stage(1, out2, x, up2(disp2, x))
        disp1 = disp(1, out1)
        return [disp1, disp2, disp3, disp4]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX model's distributions: torch-default
        convs and transposed convs, unit/zero BatchNorm."""
        init_module_(self, generator)
