"""Top-level objective: reprojection + smoothness.

Counterpart of unsupervised_pseuso_lidar_tpu/losses/total.py
(normalize_depth :22, total_loss :53, Losses :143).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import disp_to_depth
from unsupervised_pseuso_lidar_tpu_torch.losses.reprojection import (
    min_reprojection_loss,
    reprojection_loss,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.smoothness import smooth_loss
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import (
    banded_outputs,
    check_placement,
    row_sharded,
)


def normalize_depth(depth: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-image inverse-depth mean normalization: depth · mean_i(1/depth).
    A uniform inverse-depth scaling leaves the result unchanged, which
    removes the shrinking-depth runaway from the warp.

    The mean accumulates in fp64 and is rounded once to depth's dtype, so
    it does not depend on the device's summation order (the warp
    coordinates, and the gradient's jumps at pixel crossings, follow
    it). Under a mesh with a "spatial" axis `depth` is this rank's band
    of rows [B, (C,) R, W] and the image's sum and pixel count are the
    fp64 sums of the bands' over the data row, one all-reduce,
    differentiable (Mesh.spatial_sum): the bands may differ in height."""
    inv = 1.0 / torch.clamp(depth, min=1e-7)
    dims = tuple(range(1, depth.ndim))
    if row_sharded(mesh):
        sums = inv.sum(dim=dims, dtype=torch.float64)
        count = torch.full((1,), float(inv[0].numel()), dtype=torch.float64,
                           device=depth.device)
        totals = mesh.spatial_sum(torch.cat([sums, count]))
        m = (totals[:-1] / totals[-1]).reshape(-1, *[1] * len(dims))
    else:
        m = inv.mean(dim=dims, keepdim=True, dtype=torch.float64)
    return depth * m.to(depth.dtype)


def total_loss(
    tgt: torch.Tensor,
    refs: Sequence[torch.Tensor],
    disparities: Sequence[Sequence[torch.Tensor]],
    poses: torch.Tensor,
    intrinsics: torch.Tensor,
    mode: str = "mean",
    smooth_decay: float = 2.3,
    smooth_weight: float = 1.0,
    smooth_on: str = "depth",
    warp_impl: str = "gather",
    depth_norm: bool = False,
    ident_scale: float = 1.0,
    no_ssim: bool = False,
    min_bidirectional: bool = True,
    with_coverage: bool = False,
    mesh=None,
    scales: Sequence[int] | None = None,
    banded: Sequence[bool] | None = None,
):
    """(reprojection_loss, smooth_weight · smoothness_loss, extra): extra
    holds {"automask_keep": fraction} in 'min' mode (min_reprojection_loss)
    and, with with_coverage, {"warp_in_frame": the fraction of the warp's
    samples that land in the image} (JAX's coverage metrics stand here).

    Args:
      tgt, refs: [B, 3, H, W] target and the two reference frames.
      disparities: [disps_of_tgt, disps_of_ref0], each a list over scales
        of [B, 1, h, w] network outputs.
      poses: [B, 2, 6]; intrinsics: [B, 3, 3] or [3, 3].
      mode: 'min' (min_reprojection_loss; ident_scale, no_ssim and
        min_bidirectional apply to it only) or 'mean', 'l1', 'mse', 'ssim'
        (reprojection_loss).
      smooth_on: 'depth' (the smoothed maps are the — normalized, with
        depth_norm — target depths) or 'disp' (the raw disparities).
      mesh: the mesh the step runs under (parallel/mesh.py), or None;
        'ssim' then clamps at the global batch's threshold. Every other
        reduction here is a mean over equal blocks of images, which the
        step's all-reduce of the metrics and gradients makes global. With
        a "spatial" axis tgt and refs are the whole frames and each
        disparity this rank's band of its scale's rows (parallel/
        spatial.band), or the whole map where its net declares it whole
        (`banded`; its terms are then taken whole on every rank):
        the reductions that cross the band's edges — SSIM windows,
        vertical smoothness differences, depth_norm's per-image mean, a
        coarse scale's upsample — exchange rows or sums with the other
        bands, and each mean is spatial × the band's share of the
        image's (losses/reprojection.py, smoothness.py, above).
      scales: each disparity's scale, its map 2**scale times smaller than
        the image (trainer.depth_scales: BtsModel's five outputs are all
        at scale 0); by default 0, 1, 2, … in order. Read under a spatial
        mesh only.
      banded: whether each disparity (of both frames) is this rank's band
        of its map or the whole map, as the depth net declares it
        (layers.Banded.banded_outputs; by default spatial.banded_outputs).
        Read under a spatial mesh only, where a map of other rows raises
        ValueError (spatial.check_placement).
    """
    height = tgt.shape[2]
    scales = tuple(range(len(disparities[0]))) if scales is None else tuple(scales)
    banded = banded_outputs(mesh, height, scales) if banded is None else banded
    if row_sharded(mesh):
        # a map of the wrong rows raises here, before any exchange
        for frame in disparities:
            for scale, on_band, d in zip(scales, banded, frame):
                check_placement(d, mesh, height, scale, on_band)
    depths = [[disp_to_depth(d) for d in frame] for frame in disparities]
    if depth_norm:
        depths = [[normalize_depth(d, mesh if on_band else None)
                   for on_band, d in zip(banded, frame)] for frame in depths]
    extra = {}
    if mode == "min":
        loss_reproj, extra["automask_keep"], *in_frame = min_reprojection_loss(
            tgt, refs, depths[0], poses, intrinsics, warp_impl=warp_impl,
            ident_scale=ident_scale, no_ssim=no_ssim,
            depths_ref0=depths[1] if min_bidirectional else None,
            with_coverage=with_coverage, mesh=mesh, scales=scales, banded=banded,
        )
    else:
        result = reprojection_loss(tgt, refs, depths, poses, intrinsics, mode=mode,
                                   warp_impl=warp_impl, with_coverage=with_coverage,
                                   mesh=mesh, scales=scales, banded=banded)
        loss_reproj, *in_frame = result if with_coverage else (result,)
    if with_coverage:
        extra["warp_in_frame"] = in_frame[0]
    if smooth_on == "depth":
        loss_smooth = smooth_loss(depths[0], decay=smooth_decay, mesh=mesh, height=height,
                                  scales=scales, banded=banded)
    elif smooth_on == "disp":
        loss_smooth = smooth_loss(disparities[0], decay=smooth_decay, mesh=mesh,
                                  height=height, scales=scales, banded=banded)
    else:
        raise ValueError(f"smooth_on must be 'depth' or 'disp', got {smooth_on}")
    return loss_reproj, smooth_weight * loss_smooth, extra


@dataclass
class Losses:
    """Object-style wrapper of total_loss (the reference's Losses API):
    losses(tgt, refs, disparities, poses, intrinsics) -> total_loss with
    these settings."""

    mode: str = "mean"
    smooth_decay: float = 2.3
    smooth_weight: float = 1.0
    smooth_on: str = "depth"
    warp_impl: str = "gather"

    def forward(self, tgt, refs, disparities, poses, intrinsics, gt=None):
        return total_loss(
            tgt, refs, disparities, poses, intrinsics, mode=self.mode,
            smooth_decay=self.smooth_decay, smooth_weight=self.smooth_weight,
            smooth_on=self.smooth_on, warp_impl=self.warp_impl,
        )

    __call__ = forward
