"""Per-pixel-min photometric reprojection loss with the joint-min automask.

Counterpart of unsupervised_pseuso_lidar_tpu/losses/reprojection.py
(_full_res_depth :41, min_reprojection_loss :203). The 'mean'/'l1'/'mse'/
'ssim' modes (reprojection_loss) and the banded-warp coverage metrics are
not ported yet.

All warp jobs of a scale run as ONE batched warp (kernel A on the card):
[ref0 -> tgt, ref1 -> tgt, tgt -> ref0] stacked on the batch axis, and
their photometric errors as one kernel-B pass; the identity error of the
unwarped (ref, tgt) pairs is one more kernel-B pass.
"""

from __future__ import annotations

from typing import Sequence

import torch

from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import invert_pose, pose_matrix
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    sample_with_impl,
    warp_coords,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import photometric_loss
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear


def _full_res_depth(depth: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, 1, h, w] (or [B, h, w]) scale-s depth -> [B, H, W]."""
    if depth.ndim == 3:
        depth = depth[:, None]
    return resize_bilinear(depth, height, width)[:, 0]


def min_reprojection_loss(
    tgt: torch.Tensor,
    refs: Sequence[torch.Tensor],
    depths: Sequence[torch.Tensor],
    poses: torch.Tensor,
    intrinsics: torch.Tensor,
    no_ssim: bool = False,
    warp_impl: str = "gather",
    ident_scale: float = 1.0,
    depths_ref0: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """monodepth2-style per-pixel minimum over the two references, with
    the joint-min automask: per pixel min(min_r reproj_r, min_r ident_r ·
    ident_scale + 1e-5), so static pixels contribute the identity error
    (never 0) and ties go to the warp.

    Args:
      tgt, refs: [B, 3, H, W] target and the two reference frames.
      depths: list over scales of target-frame depths [B, 1, h, w].
      poses: [B, 2, 6] target -> ref axis-angle poses.
      intrinsics: [B, 3, 3] or [3, 3].
      depths_ref0: optional list over scales of ref0-frame depths; adds the
        backward leg (tgt warped into ref0's frame with the inverted pose,
        automasked against the same identity pair) averaged with the
        forward direction.
    Returns the scalar loss, mean over scales.
    """
    batch, _, height, width = tgt.shape
    bidirectional = depths_ref0 is not None
    t0 = pose_matrix(poses[:, 0])
    t1 = pose_matrix(poses[:, 1])
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None].expand(batch, 3, 3)
    srcs = [refs[0], refs[1]]
    tgts = [tgt, tgt]
    transforms = [t0, t1]
    if bidirectional:
        srcs.append(tgt)
        tgts.append(refs[0])
        transforms.append(invert_pose(t0))
    jobs = len(srcs)
    k_tiled = intrinsics.repeat(jobs, 1, 1)
    src = torch.cat(srcs, dim=0)
    target = torch.cat(tgts, dim=0)
    transform = torch.cat(transforms, dim=0)

    # the identity error is scale-invariant: one pass over the leading 2B
    # rows of (src, target) = (refs, tgt) serves both directions
    ident_pair = photometric_loss(
        src[: 2 * batch], target[: 2 * batch], no_ssim=no_ssim, clip_loss=0.0,
    ).mean(dim=1)
    # +1e-5 after the scale, in fp32: ties go to the warp, and an
    # exact-zero identity pixel stays masked at any ident_scale
    ident = (
        torch.minimum(ident_pair[:batch], ident_pair[batch:]).float()
        * ident_scale + 1e-5
    )
    ident_bwd = ident_pair[:batch].float() * ident_scale + 1e-5

    total = torch.zeros((), dtype=tgt.dtype, device=tgt.device)
    for i, scale_depth in enumerate(depths):
        depth_full = _full_res_depth(scale_depth, height, width)
        depth_maps = [depth_full, depth_full]
        if bidirectional:
            depth_maps.append(_full_res_depth(depths_ref0[i], height, width))
        coords = warp_coords(torch.cat(depth_maps, dim=0), transform, k_tiled)
        warped = sample_with_impl(src, coords, impl=warp_impl)
        err = photometric_loss(
            warped, target, no_ssim=no_ssim, clip_loss=0.0
        ).mean(dim=1)  # [jobs*B, H, W]
        err_f = torch.minimum(err[:batch], err[batch : 2 * batch])
        scale_loss = torch.minimum(err_f, ident).mean()
        if bidirectional:
            err_b = torch.minimum(err[2 * batch :], ident_bwd)
            scale_loss = 0.5 * (scale_loss + err_b.mean())
        total = total + scale_loss
    return total / len(depths)
