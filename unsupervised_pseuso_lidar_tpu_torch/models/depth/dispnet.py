"""DispNetS — SfMLearner's 7-down / 7-up disparity network (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/depth/dispnet.py
(DispNetS :31): seven DownsampleConvBN encoder blocks, seven transposed-
conv decoder stages with skip concatenations, each cropped to its skip
(crop_like, so any input size works), and four disparity heads
alpha · sigmoid + beta (10, 0.01) whose coarse outputs are bilinearly
upsampled into the next stage. Module names are the reference's
(conv{1-7}, upconv{1-7}.0, iconv{1-7}.0, predict_disp{1-4}.0).

Under a mesh with a "spatial" axis (trainer.bind_spatial) x is a band of
the image's rows. Its convs and transposed convs are layers.Conv2d /
ConvTranspose2d, each given its level: they exchange halos with the
neighbouring bands, and at the levels whose bands hold no whole row
(parallel/spatial.banded_level: 128x over 2 ranks at 384 rows, 64x and
128x over 4) they run on the gathered map, the first transposed conv
back at a banded level cutting its band out. _crop_like then crops only
the last band, or the whole map, and `up2` upsamples a band of a coarse
disparity with one coarse halo row each side, as the loss upsamples a
coarse scale (losses/reprojection._full_res_depth).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    Banded,
    DownsampleConvBN,
    conv,
    conv_transpose,
    init_module_,
    set_image_height,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear
from unsupervised_pseuso_lidar_tpu_torch.parallel import spatial

CONV_PLANES = (32, 64, 128, 256, 512, 512, 512)
UPCONV_PLANES = (512, 512, 256, 128, 64, 32, 16)
KERNELS = (7, 5, 3, 3, 3, 3, 3)


def _crop_like(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return a[:, :, : ref.shape[2], : ref.shape[3]]


def _upsample2x_bilinear(d: torch.Tensor, mesh, height, level: int) -> torch.Tensor:
    """The bilinear x2 resize of a level-`level` map d of an image
    `height` rows tall -> the level − 1 map, in that level's placement
    (parallel/spatial.placed). On a band:
    the band with one row of halo above and below, resized x2 and
    cropped 2 rows at each inner edge — an integer-factor resize with
    half-pixel centres reads the same rows with the same weights, and at
    the image's border the slab's own clamp is the image's."""
    if not spatial.on_bands(mesh, height, level):
        up = resize_bilinear(d, d.shape[2] * 2, d.shape[3] * 2)
        return spatial.placed(up, mesh, height, level - 1)
    rows = d.shape[2]
    bands = spatial.level_rows(mesh, height, level)
    slab = spatial.halo(d, mesh, 1, 1, bands)
    top = 2 * spatial.halo_reach(mesh, 1, 1, bands)[0]
    return resize_bilinear(slab, slab.shape[2] * 2, d.shape[3] * 2)[:, :, top:top + 2 * rows]


class DispNetS(Banded, nn.Module):
    """Returns [disp1, disp2, disp3, disp4], [B, 1, H/2^s, W/2^s], finest
    first; under a spatial mesh each a band of its scale's rows, or the
    whole map at a scale that is not banded."""

    scales = (0, 1, 2, 3)

    def __init__(self, alpha: float = 10.0, beta: float = 0.01):
        super().__init__()
        self.alpha, self.beta = alpha, beta
        cin = 3
        for i, (planes, k) in enumerate(zip(CONV_PLANES, KERNELS)):
            setattr(self, f"conv{i + 1}", DownsampleConvBN(cin, planes, k, level=i))
            cin = planes
        up_in = (CONV_PLANES[6],) + UPCONV_PLANES[:6]
        # iconv{7-1}'s input: the upconv output, the encoder skip, and from
        # iconv3 on the upsampled coarser disparity
        skips = CONV_PLANES[5::-1] + (0,)
        for j, planes in enumerate(UPCONV_PLANES):
            level = 7 - j
            setattr(self, f"upconv{level}",
                    nn.Sequential(conv_transpose(up_in[j], planes, level), nn.ReLU()))
            cin = planes + skips[j] + (1 if level <= 3 else 0)
            setattr(self, f"iconv{level}",
                    nn.Sequential(conv(cin, planes, 3, level=level - 1), nn.ReLU()))
        for s, planes in zip((4, 3, 2, 1), UPCONV_PLANES[3:]):
            setattr(self, f"predict_disp{s}",
                    nn.Sequential(conv(planes, 1, 3, level=s - 1), nn.Sigmoid()))

    def forward(self, x: torch.Tensor, height: Optional[int] = None) -> List[torch.Tensor]:
        """x: the images, or under a spatial mesh this rank's band of the
        rows of images `height` rows tall."""
        set_image_height(self, x, height)
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

        def up2(d, like, level):
            return _crop_like(_upsample2x_bilinear(d, self.mesh, self.height, level), like)

        out7 = stage(7, encoder[6], encoder[5], encoder[5])
        out6 = stage(6, out7, encoder[4], encoder[4])
        out5 = stage(5, out6, encoder[3], encoder[3])
        out4 = stage(4, out5, encoder[2], encoder[2])
        disp4 = disp(4, out4)
        out3 = stage(3, out4, encoder[1], encoder[1], up2(disp4, encoder[1], 3))
        disp3 = disp(3, out3)
        out2 = stage(2, out3, encoder[0], encoder[0], up2(disp3, encoder[0], 2))
        disp2 = disp(2, out2)
        out1 = stage(1, out2, x, up2(disp2, x, 1))
        disp1 = disp(1, out1)
        return [disp1, disp2, disp3, disp4]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX model's distributions: torch-default
        convs and transposed convs, unit/zero BatchNorm."""
        init_module_(self, generator)
