"""Photometric appearance error: SSIM/L1 blend with the outlier clamp.

Counterpart of unsupervised_pseuso_lidar_tpu/losses/photometric.py
(l1_loss :19, photometric_loss :24).
"""

from __future__ import annotations

import torch

from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import ssim_distance_fused
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import abs_


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Scalar mean absolute error (nn.L1Loss' default reduction), with
    jnp.abs' gradient rule at a tie."""
    return torch.mean(abs_(pred - target))


def photometric_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    no_ssim: bool = False,
    ssim_weight: float = 0.85,
    clip_loss: float = 0.5,
) -> torch.Tensor:
    """Per-pixel photometric error map [B, C, H, W]: ssim_weight · SSIM
    distance + (1 - ssim_weight) · L1 (L1 alone with no_ssim), clamped at
    the DETACHED mean + clip_loss · std of the map when clip_loss != 0.

    The blend runs inside kernel B on the card (one pass over pred and
    target), in the plain version on the CPU. The L1 term has jnp.abs'
    gradient rule (d|z|/dz = +1 at a tie, utils/numerics.abs_). The clamp's
    mean and std accumulate in fp64 and are rounded once: the threshold
    decides which pixels pass a gradient, so it must not depend on the
    device's summation order."""
    if no_ssim:
        photometric = abs_(target - pred)
    else:
        photometric = ssim_distance_fused(pred, target, ssim_weight)
    if clip_loss:
        stats = photometric.detach().double()
        thresh = stats.mean() + clip_loss * stats.std(correction=0)
        photometric = torch.minimum(photometric, thresh.to(photometric.dtype))
    return photometric
