"""StnDispNet — a GroupNorm 4-down / 4-up disparity net with an optional
spatial-transformer front end (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/depth/stn_dispnet.py
(affine_grid :24, StnDispNet :42). With use_stn a localization head (five
DownsampleConvGN blocks and four Linear layers) predicts an affine
transform and the input is resampled through it (grid_sample,
align_corners=False) before the depth net.

The STN branch (localization.*, fc_loc.*) is always registered, as the
reference registers it whether its forward uses it or not, so the model's
state dict is the reference's at every setting. Without use_stn it is
dead: fc_loc.0 has the reference's fixed 32·12·40 input width (its
384x1280 size) and the branch holds the identity transform
(stn_identity_state), which is what the JAX package writes for it on
export. With use_stn, fc_loc.0's input width
is 32·⌈H/32⌉·⌈W/32⌉ of `image_shape` (flax infers it at init), flattened
CHW as in the reference. The loaders (train/checkpoint.py) keep a dead
branch, or one whose width is not this model's, at its own values, as the
JAX package's import ignores them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    DownsampleConvGN,
    UpconvGN,
    conv,
    init_module_,
    lecun_normal_,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import grid_sample

LOCALIZATION_WIDTHS = (16, 32, 32, 32, 32)
FC_WIDTHS = (1280, 256, 128, 6)
# the reference's fixed STN input size (H, W)
REFERENCE_SHAPE = (384, 1280)
IDENTITY_THETA = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """F.affine_grid's align_corners=False grid, computed as the JAX
    version does: theta [B, 2, 3] over the pixel centers' normalized
    coordinates (2i + 1) / size − 1 -> [B, H, W, 2] (x, y)."""
    xs = (torch.arange(width, dtype=torch.float32, device=theta.device) * 2 + 1) / width - 1
    ys = (torch.arange(height, dtype=torch.float32, device=theta.device) * 2 + 1) / height - 1
    base = torch.stack([xs[None, :].expand(height, width),
                        ys[:, None].expand(height, width),
                        torch.ones(height, width, device=theta.device)], dim=-1)
    return torch.einsum("bij,hwj->bhwi", theta, base)


def stn_identity_state() -> Dict[str, torch.Tensor]:
    """The STN branch as the JAX package exports it for a model without
    use_stn: the identity transform at the reference's size (zero conv and
    Linear weights and biases, unit GroupNorm, fc_loc.6's bias the
    identity theta), under its state-dict keys."""
    out: Dict[str, torch.Tensor] = {}
    cin = 3
    for j, cout in enumerate(LOCALIZATION_WIDTHS):
        for conv_idx, norm_idx, c in ((0, 1, cin), (3, 4, cout)):
            out[f"localization.{j}.{conv_idx}.weight"] = torch.zeros(cout, c, 3, 3)
            out[f"localization.{j}.{conv_idx}.bias"] = torch.zeros(cout)
            out[f"localization.{j}.{norm_idx}.weight"] = torch.ones(cout)
            out[f"localization.{j}.{norm_idx}.bias"] = torch.zeros(cout)
        cin = cout
    flat = stn_flat_width(REFERENCE_SHAPE)
    for i, width in enumerate(FC_WIDTHS):
        out[f"fc_loc.{2 * i}.weight"] = torch.zeros(width, flat)
        out[f"fc_loc.{2 * i}.bias"] = torch.zeros(width)
        flat = width
    out[f"fc_loc.{2 * len(FC_WIDTHS) - 2}.bias"] = torch.tensor(IDENTITY_THETA)
    return out


def stn_flat_width(image_shape: Tuple[int, int]) -> int:
    """The localization map's CHW flatten width at `image_shape`: five
    stride-2 convs (⌈n/2⌉ each) to 32 channels."""
    h, w = image_shape
    for _ in LOCALIZATION_WIDTHS:
        h, w = -(-h // 2), -(-w // 2)
    return LOCALIZATION_WIDTHS[-1] * h * w


class StnDispNet(nn.Module):
    """Returns [disp] ([B, 1, H', W'], H' = 16·⌈⌈⌈⌈H/2⌉/2⌉/2⌉/2⌉)."""

    def __init__(self, use_stn: bool = False,
                 image_shape: Tuple[int, int] = REFERENCE_SHAPE):
        super().__init__()
        self.use_stn = use_stn
        cin = 3
        blocks = []
        for width in LOCALIZATION_WIDTHS:
            blocks.append(DownsampleConvGN(cin, width))
            cin = width
        self.localization = nn.Sequential(*blocks)
        flat = stn_flat_width(image_shape if use_stn else REFERENCE_SHAPE)
        layers = []
        for i, width in enumerate(FC_WIDTHS):
            layers.append(nn.Linear(flat, width))
            if i < len(FC_WIDTHS) - 1:
                layers.append(nn.ReLU())
            flat = width
        self.fc_loc = nn.Sequential(*layers)
        cin = 3
        for i, width in enumerate((32, 64, 128, 256)):
            setattr(self, f"conv{i + 1}", DownsampleConvGN(cin, width))
            cin = width
        for i, width in enumerate((128, 64, 32, 16)):
            setattr(self, f"upconv_{i + 1}", UpconvGN(cin, width))
            cin = width
        self.predict = nn.Sequential(conv(16, 1, 3), nn.Sigmoid())
        self._init_stn()

    def _init_stn(self) -> None:
        """Without use_stn the branch is stn_identity_state; with it the
        last Linear is zero with the identity bias (the reference's STN
        init), so the transform starts as the identity."""
        if not self.use_stn:
            self.load_state_dict(stn_identity_state(), strict=False)
            return
        with torch.no_grad():
            self.fc_loc[-1].weight.zero_()
            self.fc_loc[-1].bias.copy_(torch.tensor(IDENTITY_THETA))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.use_stn:
            theta = self.fc_loc(self.localization(x).flatten(1)).reshape(-1, 2, 3)
            x = grid_sample(x, affine_grid(theta, x.shape[2], x.shape[3]),
                            align_corners=False)
        out = x
        for i in range(4):
            out = getattr(self, f"conv{i + 1}")(out)
        for i in range(4):
            out = getattr(self, f"upconv_{i + 1}")(out)
        return [self.predict(out)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX model's distributions: torch-default
        convs and transposed convs, unit/zero GroupNorm; with use_stn the
        localization convs the same way, lecun-normal Linear weights with
        zero biases, and a last Linear of zero weights and the identity
        bias (the reference's STN init). Without use_stn the branch is the
        identity."""
        init_module_(self, generator)
        with torch.no_grad():
            for m in self.fc_loc:
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
        self._init_stn()
