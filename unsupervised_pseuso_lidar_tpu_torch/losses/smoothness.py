"""Second-order smoothness regularizer over predicted maps.

Counterpart of unsupervised_pseuso_lidar_tpu/losses/smoothness.py
(smooth_loss :23).
"""

from __future__ import annotations

from typing import Sequence

import torch

from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import (
    banded_outputs,
    halo,
    level_rows,
    row_sharded,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import abs_ as _abs


def _gradients(pred: torch.Tensor):
    """(d/dx, d/dy) finite differences of [B, C, H, W] maps."""
    dy = pred[:, :, 1:, :] - pred[:, :, :-1, :]
    dx = pred[:, :, :, 1:] - pred[:, :, :, :-1]
    return dx, dy


def _banded_terms(band: torch.Tensor, mesh, image_rows: int, rows_of_bands):
    """The four terms of smooth_loss on this rank's band [B, C, R, W] of
    row-sharded maps `image_rows` rows tall, each spatial × this rank's
    share of the image's mean: its sum over the differences whose TOP row
    the band holds, divided by the image's count of them over the spatial
    size (so that the mean over the ranks, which the step takes, is the
    image's mean, the bands being of any height). The vertical
    differences read the two rows below the band (halo, past a band of
    one row: `rows_of_bands`, every band's row count); where the image
    ends fewer come, and the band holds as many differences fewer."""
    rows = band.shape[2]
    ext = halo(band, mesh, 0, 2, rows_of_bands)
    dx, dy = _gradients(ext)
    dx2 = _gradients(dx[:, :, :rows])[0]
    dxdy = _gradients(dx)[1][:, :, :rows]
    dydx = _gradients(dy)[0][:, :, :rows]
    dy2 = _gradients(dy)[1][:, :, :rows]

    def share(d, count_rows):
        per_row = d.shape[0] * d.shape[1] * d.shape[3]
        return _abs(d).sum() / (per_row * count_rows / mesh.spatial)

    return (share(dx2, image_rows) + share(dxdy, image_rows - 1)
            + share(dydx, image_rows - 1) + share(dy2, image_rows - 2))


def smooth_loss(
    pred_maps: Sequence[torch.Tensor] | torch.Tensor, decay: float = 2.3, mesh=None,
    height: int | None = None, scales: Sequence[int] | None = None,
    banded: Sequence[bool] | None = None,
) -> torch.Tensor:
    """Sum over scales (finest first, weights 1, 1/decay, 1/decay², …) of
    the mean absolute second-order differences dx², dxdy, dydx, dy².
    Under a mesh with a "spatial" axis map i is of scale scales[i] (by
    default i) of an image `height` rows tall (ceil(height / 2**scale)
    rows whole): where banded[i] (its net's declared placement; by
    default spatial.banded_outputs) this rank's band of its rows, each
    mean its share (_banded_terms), or else the whole map (a scale that
    is not banded, StnDispNet's 16·ceil(H/16) rows), each of whose means
    every rank takes whole — their mean over the ranks is the image's."""
    if not isinstance(pred_maps, (tuple, list)):
        pred_maps = [pred_maps]
    if row_sharded(mesh) and height is None:
        raise ValueError("smooth_loss under a spatial mesh needs the image's height")
    scales = range(len(pred_maps)) if scales is None else scales
    banded = banded_outputs(mesh, height, scales) if banded is None else banded
    loss = torch.zeros((), dtype=pred_maps[0].dtype, device=pred_maps[0].device)
    weight = 1.0
    for scale, on_band, scaled_map in zip(scales, banded, pred_maps):
        if on_band:
            image_rows = -(-height // 2 ** scale)
            loss = loss + weight * _banded_terms(scaled_map, mesh, image_rows,
                                                 level_rows(mesh, height, scale))
            weight /= decay
            continue
        dx, dy = _gradients(scaled_map)
        dx2, dxdy = _gradients(dx)
        dydx, dy2 = _gradients(dy)
        loss = loss + weight * (
            _abs(dx2).mean() + _abs(dxdy).mean() + _abs(dydx).mean()
            + _abs(dy2).mean()
        )
        weight /= decay
    return loss
