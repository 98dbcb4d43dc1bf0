"""PoseNet — 7 stride-2 convs over the channel-concatenated triplet (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/pose/posenet.py
(PoseNet :20): conv widths (16, 32, 64, 128, 256, 256, 256), kernels
(7, 5, 3, …), ReLU, a 1x1 pose head, the spatial mean and a 0.06 output
scale -> [B, num_refs, 6]. The s2d_convs layout rewrite there computes the
same convs and has no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import StridedConv2d

CHANNELS = (16, 32, 64, 128, 256, 256, 256)
KERNELS = (7, 5, 3, 3, 3, 3, 3)


class PoseNet(nn.Module):
    def __init__(self, nb_ref_imgs: int = 2):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        cin = 3 * (1 + nb_ref_imgs)
        for i, (width, k) in enumerate(zip(CHANNELS, KERNELS)):
            conv = StridedConv2d(cin, width, k, stride=2, padding=(k - 1) // 2)
            setattr(self, f"conv{i + 1}", nn.Sequential(conv, nn.ReLU()))
            cin = width
        self.pose_pred = nn.Conv2d(cin, 6 * nb_ref_imgs, 1)

    def forward(
        self, image: torch.Tensor, context: Sequence[torch.Tensor]
    ) -> torch.Tensor:
        """image [B, 3, H, W] + nb_ref_imgs refs -> poses [B, nb_ref_imgs, 6]."""
        if len(context) != self.nb_ref_imgs:
            raise ValueError(
                f"PoseNet expects {self.nb_ref_imgs} reference images, "
                f"got {len(context)}"
            )
        x = torch.cat([image, *context], dim=1)
        for i in range(len(CHANNELS)):
            x = getattr(self, f"conv{i + 1}")(x)
        pose = self.pose_pred(x).mean(dim=(2, 3))
        return 0.06 * pose.reshape(pose.shape[0], self.nb_ref_imgs, 6)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded xavier-uniform kernels and zero biases (the JAX init)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    bound = (6.0 / (fan_in + fan_out)) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.zero_()
