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


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    """Per-image inverse-depth mean normalization: depth · mean_i(1/depth).
    A uniform inverse-depth scaling leaves the result unchanged, which
    removes the shrinking-depth runaway from the warp.

    The mean accumulates in fp64 and is rounded once to depth's dtype, so
    it does not depend on the device's summation order (the warp
    coordinates, and the gradient's jumps at pixel crossings, follow
    it)."""
    inv = 1.0 / torch.clamp(depth, min=1e-7)
    m = inv.mean(dim=tuple(range(1, depth.ndim)), keepdim=True,
                 dtype=torch.float64)
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
      mesh: the data mesh the step runs under (parallel/mesh.py), or None;
        'ssim' then clamps at the global batch's threshold. Every other
        reduction here is a mean over equal shards, which the step's
        all-reduce of the metrics and gradients makes global.
    """
    depths = [[disp_to_depth(d) for d in frame] for frame in disparities]
    if depth_norm:
        depths = [[normalize_depth(d) for d in frame] for frame in depths]
    extra = {}
    if mode == "min":
        loss_reproj, extra["automask_keep"], *in_frame = min_reprojection_loss(
            tgt, refs, depths[0], poses, intrinsics, warp_impl=warp_impl,
            ident_scale=ident_scale, no_ssim=no_ssim,
            depths_ref0=depths[1] if min_bidirectional else None,
            with_coverage=with_coverage,
        )
    else:
        result = reprojection_loss(tgt, refs, depths, poses, intrinsics, mode=mode,
                                   warp_impl=warp_impl, with_coverage=with_coverage,
                                   mesh=mesh)
        loss_reproj, *in_frame = result if with_coverage else (result,)
    if with_coverage:
        extra["warp_in_frame"] = in_frame[0]
    if smooth_on == "depth":
        loss_smooth = smooth_loss(depths[0], decay=smooth_decay)
    elif smooth_on == "disp":
        loss_smooth = smooth_loss(disparities[0], decay=smooth_decay)
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
