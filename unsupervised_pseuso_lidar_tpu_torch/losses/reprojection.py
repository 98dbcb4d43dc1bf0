"""Photometric reprojection losses: the multi-scale bidirectional objective
('mean', 'l1', 'mse', 'ssim') and the per-pixel-min objective with the
joint-min automask ('min').

Counterpart of unsupervised_pseuso_lidar_tpu/losses/reprojection.py
(_full_res_depth :41, reprojection_loss :82, min_reprojection_loss :203).
The port's warp is exact (JAX's warp_impl='gather'), so it has no band
whose coverage to report; with_coverage reports in its place the fraction
of warp samples that land in the image (geometry/warp.in_frame_fraction),
which reads 0.0 exactly where JAX's band_coverage does: when no sample
lands in the image.

All warp jobs of a call run as ONE batched warp (kernel A on the card):
'min' stacks [ref0 -> tgt, ref1 -> tgt, tgt -> ref0] per scale, and
computes their photometric errors as one kernel-B pass, plus one more for
the identity error of the unwarped (ref, tgt) pairs; the other modes stack
every scale's jobs into one warp, and 'ssim' their errors into one
kernel-B pass.

Under a mesh with a "spatial" axis (parallel/spatial.py) tgt and refs are
the WHOLE frames of this rank's images and the depths this rank's band of
rows: the warp samples the whole source frames at the band's coordinates
(kernel A on a band of grid rows), the targets are the band's rows, the
SSIM windows cross the band's edges through a halo, a coarse scale's
depth is upsampled on the band's slab, or whole where the scale is not
banded or the upsample is no integer factor (_full_res_depth), and every mean
is the band's times parallel/spatial.band_weight: spatial × its share of
the image's mean, the bands being of any height, so that the mean over
the ranks, which the step takes, is the image's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import invert_pose, pose_matrix
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    in_frame_fraction,
    sample_with_impl,
    warp_coords,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import photometric_loss
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import (
    band,
    band_weight,
    first_band,
    gather_band,
    halo,
    is_band,
    level_rows,
    row_sharded,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.device import constant
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import abs_, div

REPROJECTION_MODES = ("mean", "l1", "mse", "ssim")


def _full_res_depth(depth: torch.Tensor, height: int, width: int,
                    mesh=None, scale: int = 0) -> torch.Tensor:
    """[B, 1, h, w] (or [B, h, w]) scale-s depth -> [B, H, W].

    Under a mesh with a "spatial" axis the result is this rank's band of
    the image's rows. Where `depth` is this rank's band of the scale-s
    map (parallel/spatial.is_band) and H a multiple of f = 2^s, the band
    with one coarse row of halo above and below (parallel/spatial.halo,
    differentiable) is upsampled by the integer factor f and f rows are
    cropped at each end but at the image's border, where the slab's own
    clamp is the image's. An integer-factor upsample with half-pixel
    centres is shift-equivariant — the same source rows and weights — so
    the band's rows are exactly the whole map's. Where H is no multiple
    of f the resize is no integer factor: the band is gathered with its
    gradient (parallel/spatial.gather_band; the ranks' cotangents add),
    resized whole and the band's rows taken. Where `depth` is the whole
    map (every rank's copy: a level that is not banded, StnDispNet's
    16·ceil(H/16) rows), it is resized whole and the band's rows taken."""
    if depth.ndim == 3:
        depth = depth[:, None]
    if not row_sharded(mesh):
        return resize_bilinear(depth, height, width)[:, 0]
    rows = band(mesh, height)
    if not is_band(depth, mesh, height, scale):
        return resize_bilinear(depth, height, width)[:, 0, rows]
    factor = 2 ** scale
    if height % factor:
        whole = gather_band(depth, mesh, height, scale)
        return resize_bilinear(whole, height, width)[:, 0, rows]
    count = rows.stop - rows.start
    if factor == 1:
        return resize_bilinear(depth, count, width)[:, 0]
    slab = halo(depth, mesh, 1, 1, level_rows(mesh, height, scale))
    full = resize_bilinear(slab, slab.shape[2] * factor, width)
    top = 0 if first_band(mesh) else factor
    return full[:, 0, top:top + count]


def _channel_mean(err: torch.Tensor) -> torch.Tensor:
    """Mean over the channels of [B, C, H, W] as adds in channel order and
    a true division: the same bits on every device (a mean kernel's order
    and its division are the device's own), so the per-pixel minima below
    pick the same side on the card as on the CPU."""
    total = err[:, 0]
    for c in range(1, err.shape[1]):
        total = total + err[:, c]
    return div(total, err.shape[1])


def _share(mean: torch.Tensor, mesh, height: int) -> torch.Tensor:
    """A mean over this rank's band -> spatial × the band's share of the
    image's mean (parallel/spatial.band_weight; the mean itself where the
    weight is 1)."""
    weight = band_weight(mesh, height)
    return mean if weight == 1.0 else mean * weight


def reprojection_loss(
    tgt: torch.Tensor,
    refs: Sequence[torch.Tensor],
    depths: Sequence[Sequence[torch.Tensor]],
    poses: torch.Tensor,
    intrinsics: torch.Tensor,
    mode: str = "mean",
    warp_impl: str = "gather",
    with_coverage: bool = False,
    mesh=None,
    scales: Sequence[int] | None = None,
):
    """Bidirectional multi-scale reprojection loss.

    Args:
      tgt, refs: [B, 3, H, W] target and the two reference frames.
      depths: [depths_of_tgt, depths_of_ref0], each a list over scales of
        [B, 1, h, w] depth maps (finest first).
      poses: [B, 2, 6] target -> ref axis-angle poses.
      intrinsics: [B, 3, 3] or [3, 3].
      mode: 'mean' or 'l1' (|warped - target|, jnp.abs' rule at a tie),
        'mse' ((warped - target)²) or 'ssim' (photometric_loss: the 0.85
        SSIM + 0.15 L1 blend with its mean + 0.5 std clamp, the GLOBAL
        batch's under a `mesh`).
      mesh: the step's mesh or None; with a "spatial" axis the depths are
        this rank's band of rows (module docstring).
      scales: each depth's scale (its map 2**scale times smaller than the
        image; by default 0, 1, 2, … in order), read under a spatial mesh.
    Returns the scalar loss, or (loss, in-frame fraction of every job's
    samples) with with_coverage. Each scale's depth is upsampled to full
    resolution; the jobs are, per scale, ref0 -> tgt and ref1 -> tgt with
    tgt's depth at weight 1/(4S), then per scale tgt -> ref0 with ref0's
    depth and the inverted pose at weight 1/(2S); the loss is the weighted
    sum of the per-job means.
    """
    if mode not in REPROJECTION_MODES:
        raise ValueError(f"Unsupported reprojection mode: {mode}")
    batch, _, height, width = tgt.shape
    rows = band(mesh, height)
    num_scales = len(depths[0])
    scales = range(num_scales) if scales is None else scales
    # the per-job transforms in fp64 (device-independent coordinates, see
    # warp_coords)
    t0 = pose_matrix(poses[:, 0].double())
    t1 = pose_matrix(poses[:, 1].double())
    t0_inv = invert_pose(t0)

    srcs, tgts, transforms, depth_maps, weights = [], [], [], [], []
    fwd_w = 1.0 / (2.0 * num_scales) / 2.0
    for scale, scale_depth in zip(scales, depths[0]):
        depth_full = _full_res_depth(scale_depth, height, width, mesh, scale)
        for ref, transform in ((refs[0], t0), (refs[1], t1)):
            srcs.append(ref)
            tgts.append(tgt[:, :, rows])
            transforms.append(transform)
            depth_maps.append(depth_full)
            weights.append(fwd_w)
    bwd_w = 1.0 / (2.0 * num_scales)
    for scale, scale_depth in zip(scales, depths[1]):
        srcs.append(tgt)
        tgts.append(refs[0][:, :, rows])
        transforms.append(t0_inv)
        depth_maps.append(_full_res_depth(scale_depth, height, width, mesh, scale))
        weights.append(bwd_w)

    jobs = len(srcs)
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None].expand(batch, 3, 3)
    coords = warp_coords(torch.cat(depth_maps, dim=0), torch.cat(transforms, dim=0),
                         intrinsics.repeat(jobs, 1, 1), row_start=rows.start,
                         height=height)
    warped = sample_with_impl(torch.cat(srcs, dim=0), coords, impl=warp_impl)
    target = torch.cat(tgts, dim=0)
    if mode in ("mean", "l1"):
        err = abs_(warped - target)
    elif mode == "mse":
        err = (warped - target) ** 2
    else:
        err = photometric_loss(warped, target, no_ssim=False, mesh=mesh, height=height)
    per_job = err.reshape(jobs, -1).mean(dim=1)
    loss = _share(torch.sum(per_job * constant(tuple(weights), per_job.dtype, per_job.device)),
                  mesh, height)
    if with_coverage:
        return loss, _share(in_frame_fraction(coords, height), mesh, height)
    return loss


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
    with_coverage: bool = False,
    mesh=None,
    scales: Sequence[int] | None = None,
):
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
      scales: each depth's scale (by default 0, 1, 2, … in order), read
        under a spatial mesh.
    Returns (the scalar loss, mean over scales; automask_keep, the
    fraction of pixels whose warp error wins the joint min — the pixels
    that still carry photometric gradient — the two directions averaged,
    then the scales, as JAX's with_coverage reports it; detached), and
    with with_coverage the in-frame fraction of the warp samples (the mean
    over scales of each scale's stacked jobs, as JAX averages its
    coverage). Under a mesh with a "spatial" axis the depths are this
    rank's band of rows (module docstring).
    """
    batch, _, height, width = tgt.shape
    rows = band(mesh, height)
    bidirectional = depths_ref0 is not None
    # the per-job transforms in fp64, like the rest of warp_coords' 3x3
    # geometry (device-independent coordinates, see warp_coords)
    t0 = pose_matrix(poses[:, 0].double())
    t1 = pose_matrix(poses[:, 1].double())
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None].expand(batch, 3, 3)
    srcs = [refs[0], refs[1]]
    tgts = [tgt[:, :, rows], tgt[:, :, rows]]
    transforms = [t0, t1]
    if bidirectional:
        srcs.append(tgt)
        tgts.append(refs[0][:, :, rows])
        transforms.append(invert_pose(t0))
    jobs = len(srcs)
    k_tiled = intrinsics.repeat(jobs, 1, 1)
    src = torch.cat(srcs, dim=0)
    target = torch.cat(tgts, dim=0)
    transform = torch.cat(transforms, dim=0)

    # the identity error is scale-invariant: one pass over the leading 2B
    # rows of (src, target) = (refs, tgt) serves both directions
    ident_pair = _channel_mean(photometric_loss(
        src[: 2 * batch, :, rows], target[: 2 * batch], no_ssim=no_ssim, clip_loss=0.0,
        mesh=mesh, height=height,
    ))
    # +1e-5 after the scale, in fp32: ties go to the warp, and an
    # exact-zero identity pixel stays masked at any ident_scale
    ident = (
        torch.minimum(ident_pair[:batch], ident_pair[batch:]).float()
        * ident_scale + 1e-5
    )
    ident_bwd = ident_pair[:batch].float() * ident_scale + 1e-5

    total = torch.zeros((), dtype=tgt.dtype, device=tgt.device)
    keeps, in_frame = [], []
    scales = range(len(depths)) if scales is None else scales
    for i, (scale, scale_depth) in enumerate(zip(scales, depths)):
        depth_full = _full_res_depth(scale_depth, height, width, mesh, scale)
        depth_maps = [depth_full, depth_full]
        if bidirectional:
            depth_maps.append(_full_res_depth(depths_ref0[i], height, width, mesh, scale))
        coords = warp_coords(torch.cat(depth_maps, dim=0), transform, k_tiled,
                             row_start=rows.start, height=height)
        if with_coverage:
            in_frame.append(in_frame_fraction(coords, height))
        warped = sample_with_impl(src, coords, impl=warp_impl)
        err = _channel_mean(photometric_loss(
            warped, target, no_ssim=no_ssim, clip_loss=0.0, mesh=mesh, height=height,
        ))  # [jobs*B, H, W]
        err_f = torch.minimum(err[:batch], err[batch : 2 * batch])
        keep = (err_f <= ident).float().mean()
        scale_loss = torch.minimum(err_f, ident).mean()
        if bidirectional:
            keep = 0.5 * (keep + (err[2 * batch :] <= ident_bwd).float().mean())
            err_b = torch.minimum(err[2 * batch :], ident_bwd)
            scale_loss = 0.5 * (scale_loss + err_b.mean())
        keeps.append(keep)
        total = total + scale_loss
    out = (_share(total / len(depths), mesh, height),
           _share(torch.stack(keeps).mean().detach(), mesh, height))
    if with_coverage:
        out += (_share(torch.stack(in_frame).mean(), mesh, height),)
    return out
