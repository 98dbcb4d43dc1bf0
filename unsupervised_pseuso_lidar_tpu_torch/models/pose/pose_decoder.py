"""PoseDecoder — monodepth2's pose head over encoder features (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/pose/pose_decoder.py
(PoseDecoder :20): a shared 1x1 squeeze conv + ReLU on the deepest
feature map of each input, the squeezed maps concatenated, two 3x3 convs +
ReLU and a 1x1 conv to 6 values a frame, the spatial mean and a 0.01 scale,
split into (axisangle, translation), each [B, num_frames, 1, 3]. The
parameters are monodepth2's `net` ModuleList (net.0 = squeeze, net.1-3 =
the pose convs). flax infers the squeeze conv's input width; here it is
num_ch_enc[-1] (ResNet-18's 512 by default, 2048 for ResNet-50).

It takes encoder features, not frames: a trainer that calls a pose net
with (image, refs) cannot use it, and train.trainer.create_train_state
raises TypeError for it as the JAX package's does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import conv, init_module_


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 num_input_features: int = 2,
                 num_frames_to_predict_for: int | None = None, stride: int = 1):
        super().__init__()
        if num_frames_to_predict_for is None:
            num_frames_to_predict_for = num_input_features - 1
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            conv(num_ch_enc[-1], 256, 1),
            conv(num_input_features * 256, 256, 3, stride),
            conv(256, 256, 3, stride),
            conv(256, 6 * num_frames_to_predict_for, 1),
        ])

    def forward(self, input_features: Sequence[Sequence[torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One feature list per input frame -> (axisangle, translation)."""
        squeeze = self.net[0]
        out = torch.cat([torch.relu(squeeze(f[-1])) for f in input_features], 1)
        out = torch.relu(self.net[1](out))
        out = torch.relu(self.net[2](out))
        out = self.net[3](out).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded torch-default conv init (the JAX model's)."""
        init_module_(self, generator)
