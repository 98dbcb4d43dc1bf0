"""Second-order smoothness regularizer over predicted maps.

Counterpart of unsupervised_pseuso_lidar_tpu/losses/smoothness.py
(smooth_loss :23).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _gradients(pred: torch.Tensor):
    """(d/dx, d/dy) finite differences of [B, C, H, W] maps."""
    dy = pred[:, :, 1:, :] - pred[:, :, :-1, :]
    dx = pred[:, :, :, 1:] - pred[:, :, :, :-1]
    return dx, dy


def _abs(z: torch.Tensor) -> torch.Tensor:
    """|z| with jnp.abs' gradient rule, d|z|/dz = +1 at z >= 0 (torch.abs
    gives 0 at z == 0, which bf16 disparities hit on flat regions)."""
    return torch.where(z >= 0, z, -z)


def smooth_loss(
    pred_maps: Sequence[torch.Tensor] | torch.Tensor, decay: float = 2.3
) -> torch.Tensor:
    """Sum over scales (finest first, weights 1, 1/decay, 1/decay², …) of
    the mean absolute second-order differences dx², dxdy, dydx, dy²."""
    if not isinstance(pred_maps, (tuple, list)):
        pred_maps = [pred_maps]
    loss = torch.zeros((), dtype=pred_maps[0].dtype, device=pred_maps[0].device)
    weight = 1.0
    for scaled_map in pred_maps:
        dx, dy = _gradients(scaled_map)
        dx2, dxdy = _gradients(dx)
        dydx, dy2 = _gradients(dy)
        loss = loss + weight * (
            _abs(dx2).mean() + _abs(dxdy).mean() + _abs(dydx).mean()
            + _abs(dy2).mean()
        )
        weight /= decay
    return loss
