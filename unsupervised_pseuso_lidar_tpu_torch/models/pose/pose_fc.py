"""PoseFc — the PoseNet trunk with a fully-connected pose head (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/pose/pose_fc.py
(PoseFc :28-51), the pose model of configs/basic_config.yaml: the 7
stride-2 convs of PoseNet, a 1x1 conv to 6·nb_ref_imgs channels, the flat
map through Linear layers to 128, 32 and 6·nb_ref_imgs (ReLU between, the
last one zero-initialized), reshaped to [B, nb_ref_imgs, 6] with the
rotation half set to zero: the head predicts translation only, and the
rotation outputs get no gradient.

The flatten is torch's CHW order, the reference's (pose_fc.py:80), so a
reference-schema state dict (conv1.0 … conv7.0, pose_pred, fc_loc.0/2/4)
loads unchanged; the JAX package flattens HWC, and weights.py permutes the
first Linear's columns between the two. The first Linear's width depends
on the image size — 6·nb_ref_imgs · ceil(H/128) · ceil(W/128), 12·3·10 at
the reference's 384x1280 — so the module takes `image_shape` when it is
built (create_train_state passes config.image_shape).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import StridedConv2d, torch_default_init_
from unsupervised_pseuso_lidar_tpu_torch.models.pose.posenet import CHANNELS, KERNELS


def _conv_out(size: int) -> int:
    """Spatial size after the 7 stride-2 convs (padding (k-1)//2)."""
    for _ in CHANNELS:
        size = (size - 1) // 2 + 1
    return size


class PoseFc(nn.Module):
    def __init__(self, nb_ref_imgs: int = 2,
                 image_shape: Tuple[int, int] = (384, 1280)):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        cin = 3 * (1 + nb_ref_imgs)
        for i, (width, k) in enumerate(zip(CHANNELS, KERNELS)):
            conv = StridedConv2d(cin, width, k, stride=2, padding=(k - 1) // 2)
            setattr(self, f"conv{i + 1}", nn.Sequential(conv, nn.ReLU()))
            cin = width
        out = 6 * nb_ref_imgs
        self.pose_pred = nn.Conv2d(cin, out, 1)
        flat = out * _conv_out(image_shape[0]) * _conv_out(image_shape[1])
        self.fc_loc = nn.Sequential(
            nn.Linear(flat, 128), nn.ReLU(),
            nn.Linear(128, 32), nn.ReLU(),
            nn.Linear(32, out),
        )

    def forward(
        self, image: torch.Tensor, context: Sequence[torch.Tensor]
    ) -> torch.Tensor:
        """image [B, 3, H, W] + nb_ref_imgs refs -> poses [B, nb_ref_imgs, 6],
        rotation entries 0."""
        if len(context) != self.nb_ref_imgs:
            raise ValueError(
                f"PoseFc expects {self.nb_ref_imgs} reference images, "
                f"got {len(context)}"
            )
        x = torch.cat([image, *context], dim=1)
        for i in range(len(CHANNELS)):
            x = getattr(self, f"conv{i + 1}")(x)
        x = self.fc_loc(self.pose_pred(x).flatten(1))
        pose = x.reshape(x.shape[0], self.nb_ref_imgs, 6)
        return torch.cat([torch.zeros_like(pose[..., :3]), pose[..., 3:]], dim=-1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX model's distributions: torch-default
        convs, lecun-normal Linear kernels (truncated at 2 std) with zero
        biases, and a zero last kernel."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    torch_default_init_(m, generator)
            for m in self.fc_loc:
                if isinstance(m, nn.Linear):
                    # flax lecun_normal: truncated normal, variance 1/fan_in
                    # after the truncation's correction factor
                    std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)
                    m.bias.zero_()
            self.fc_loc[-1].weight.zero_()
