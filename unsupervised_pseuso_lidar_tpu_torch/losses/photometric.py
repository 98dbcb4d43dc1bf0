"""Photometric appearance error: SSIM/L1 blend with the outlier clamp.

Counterpart of unsupervised_pseuso_lidar_tpu/losses/photometric.py
(l1_loss :19, photometric_loss :24).
"""

from __future__ import annotations

import torch

from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import ssim_distance_fused
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import (
    first_band,
    halo,
    level_rows,
    row_sharded,
)
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
    mesh=None,
    height: int | None = None,
) -> torch.Tensor:
    """Per-pixel photometric error map [B, C, H, W]: ssim_weight · SSIM
    distance + (1 - ssim_weight) · L1 (L1 alone with no_ssim), clamped at
    the DETACHED mean + clip_loss · std of the map when clip_loss != 0.

    The blend runs inside kernel B on the card (one pass over pred and
    target), in the plain version on the CPU. The L1 term has jnp.abs'
    gradient rule (d|z|/dz = +1 at a tie, utils/numerics.abs_). The clamp's
    mean and std accumulate in fp64 and are rounded once: the threshold
    decides which pixels pass a gradient, so it must not depend on the
    device's summation order. Under a data `mesh` (parallel/mesh.py) the
    threshold is the GLOBAL batch's, as under JAX's mesh: the ranks' fp64
    sums of the map and of its square and their counts are all-reduced.

    Under a mesh with a "spatial" axis pred and target are this rank's
    band of the rows of images `height` rows tall, and the SSIM runs on a
    slab: the band plus one halo row from each neighbouring band
    (parallel/spatial.halo; none at the image's top and bottom, where the
    kernel's own reflection is the image's). The slab's outer rows are
    dropped. Their cotangent is then
    0, so kernel C's dx on the slab is exact as it is, and the halo's
    backward returns the halo rows' dx to the bands that own them."""
    if no_ssim:
        photometric = abs_(target - pred)
    elif row_sharded(mesh):
        if height is None:
            raise ValueError("photometric_loss under a spatial mesh needs the image's height")
        rows, channels = pred.shape[2], pred.shape[1]
        slab = halo(torch.cat([pred, target], dim=1), mesh, 1, 1, level_rows(mesh, height, 0))
        slab_pred = slab[:, :channels].contiguous()
        slab_target = slab[:, channels:].contiguous()
        if not target.requires_grad:
            slab_target = slab_target.detach()  # a data frame: no dy to compute
        top = 0 if first_band(mesh) else 1
        photometric = ssim_distance_fused(slab_pred, slab_target,
                                          ssim_weight)[:, :, top:top + rows]
    else:
        photometric = ssim_distance_fused(pred, target, ssim_weight)
    if clip_loss:
        stats = photometric.detach().double()
        if mesh is not None and mesh.distributed:
            count = torch.full((), float(stats.numel()), dtype=torch.float64,
                               device=stats.device)
            sums = mesh.all_reduce_(torch.stack([stats.sum(), (stats * stats).sum(), count]))
            mean = sums[0] / sums[2]
            std = torch.sqrt(torch.clamp(sums[1] / sums[2] - mean * mean, min=0.0))
            thresh = mean + clip_loss * std
        else:
            thresh = stats.mean() + clip_loss * stats.std(correction=0)
        photometric = torch.minimum(photometric, thresh.to(photometric.dtype))
    return photometric
