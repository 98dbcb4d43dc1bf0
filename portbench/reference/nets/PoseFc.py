"""Plain PyTorch reference of PoseFc.

Seven stride-2 convs (16, 32, 64, 128, 256, 256, 256 wide; kernels 7, 5,
3, ...), a 1x1 conv to 6 * refs channels, three Linear layers (128, 32,
6 * refs), the rotation half of each pose set to 0; plain `torch.nn`
layers under the program's state-dict names.

`build(kwargs, image_shape)` takes the keyword arguments the
configuration gives the program's model of this name and the image size
(the Linear layers' width depends on it).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn


POSE_CHANNELS = (16, 32, 64, 128, 256, 256, 256)
POSE_KERNELS = (7, 5, 3, 3, 3, 3, 3)


def _strided_out(size: int) -> int:
    for _ in POSE_CHANNELS:
        size = (size - 1) // 2 + 1
    return size


class PoseFc(nn.Module):
    """(tgt [B, 3, H, W], [ref0, ref1]) -> poses [B, 2, 6], rotation 0."""

    def __init__(self, image_shape: Tuple[int, int], refs: int = 2):
        super().__init__()
        self.refs = refs
        cin = 3 * (1 + refs)
        for i, (width, k) in enumerate(zip(POSE_CHANNELS, POSE_KERNELS)):
            setattr(self, f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(cin, width, k, 2, (k - 1) // 2), nn.ReLU()))
            cin = width
        out = 6 * refs
        self.pose_pred = nn.Conv2d(cin, out, 1)
        flat = out * _strided_out(image_shape[0]) * _strided_out(image_shape[1])
        self.fc_loc = nn.Sequential(nn.Linear(flat, 128), nn.ReLU(), nn.Linear(128, 32),
                                    nn.ReLU(), nn.Linear(32, out))

    def forward(self, image, context: Sequence[torch.Tensor]):
        x = torch.cat([image, *context], dim=1)
        for i in range(len(POSE_CHANNELS)):
            x = getattr(self, f"conv{i + 1}")(x)
        x = self.fc_loc(self.pose_pred(x).flatten(1))
        pose = x.reshape(x.shape[0], self.refs, 6)
        return torch.cat([torch.zeros_like(pose[..., :3]), pose[..., 3:]], dim=-1)


def build(kwargs: Dict, image_shape: Tuple[int, int]) -> nn.Module:
    """(tgt [B, 3, H, W], [ref0, ref1]) -> poses [B, refs, 6]."""
    return PoseFc(tuple(image_shape), **kwargs)
