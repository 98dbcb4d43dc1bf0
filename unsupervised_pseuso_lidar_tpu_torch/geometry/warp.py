"""Inverse warping: disparity -> depth, sample coordinates, the warp.

Counterpart of unsupervised_pseuso_lidar_tpu/geometry/warp.py
(disp_to_depth :23, depth_to_disp :32, disp_to_depth_ranged :39,
warp_coords :54-109, sample_with_impl :112, inverse_warp_from_matrix
:202, inverse_warp :284). `in_frame_fraction` stands where JAX's
coverage_from_coords (:237) reads the banded warp's coverage.
"""

from __future__ import annotations

import torch

from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import pose_matrix
from unsupervised_pseuso_lidar_tpu_torch.ops.cuda.kernels import warp_bilinear
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import div

WARP_IMPLS = ("gather", "mxu", "pallas")


def disp_to_depth(disp: torch.Tensor, alpha: float = 10.0, beta: float = 0.01):
    """Network sigmoid output -> depth: D = 1 / (alpha * disp + beta)."""
    return 1.0 / (alpha * disp + beta)


def depth_to_disp(depth: torch.Tensor, alpha: float = 10.0, beta: float = 0.01):
    """Inverse of disp_to_depth: disp = (1 / D - beta) / alpha."""
    return (1.0 / depth - beta) / alpha


def disp_to_depth_ranged(disp: torch.Tensor, min_depth: float = 0.1,
                         max_depth: float = 100.0):
    """The monodepth2 range mapping -> (scaled_disp, depth), depth in
    [min_depth, max_depth]."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def warp_coords(
    depth: torch.Tensor,
    transform: torch.Tensor,
    intrinsics: torch.Tensor,
    eps: float = 1e-5,
    row_start: int = 0,
    height: int | None = None,
) -> torch.Tensor:
    """Target-frame depth [B, H, W] + rigid transform [B, 4, 4] +
    intrinsics [B, 3, 3] (or [3, 3]) -> [B, H, W, 2] normalized sample
    coordinates.

    `depth` may be a band of the target image's rows (a mesh's "spatial"
    axis): rows [row_start, row_start + R) of an image `height` rows tall
    (default: depth's own rows). The pixel rows are then row_start +
    arange(R), and y is normalized by the image's height − 1, so the band
    gets exactly its rows of the whole image's coordinates.

    The folded form of project(transform(backproject(...))): with
    P = K T[:3], cam = D (P[:, :3] K^-1) u_h + P[:, 3], so each job needs
    one 3x3 matrix M and one 3-vector t and the per-pixel work is an
    affine function of the pixel grid times depth.

    The per-job 3x3 products and the inverse run in fp64 (JAX: fp32) and
    are rounded once to depth's dtype, and the normalization by (size - 1)
    is a true division on every device (utils/numerics.div): so the
    coordinates do not depend on the device's BLAS or on how it divides
    by a scalar. The warp's gradient jumps where a sample crosses a
    pixel, so a one-ulp difference in the coordinates would change the
    gradient of the pixels it moves across one."""
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None]
    _, rows, width = depth.shape
    if height is None:
        height = rows
    dtype = depth.dtype
    k = intrinsics.double()
    proj = k @ transform[:, :3, :].double()  # [B,3,4]
    m = (proj[:, :, :3] @ torch.linalg.inv(k)).to(dtype)  # K T[:3,:3] K^-1
    t = proj[:, :, 3].to(dtype)  # K T[:3,3]
    u = torch.arange(width, dtype=dtype, device=depth.device)[None, None, :]
    v = torch.arange(row_start, row_start + rows, dtype=dtype,
                     device=depth.device)[None, :, None]

    def cam_row(i: int) -> torch.Tensor:
        affine = (
            m[:, i, 0][:, None, None] * u
            + m[:, i, 1][:, None, None] * v
            + m[:, i, 2][:, None, None]
        )
        return depth * affine + t[:, i][:, None, None]

    z = cam_row(2) + eps
    x = cam_row(0) / z
    y = cam_row(1) / z
    gx = (div(x, width - 1) - 0.5) * 2.0
    gy = (div(y, height - 1) - 0.5) * 2.0
    return torch.stack([gx, gy], dim=-1)


def sample_with_impl(
    img: torch.Tensor, coords: torch.Tensor, impl: str = "gather"
) -> torch.Tensor:
    """Bilinear-sample NCHW `img` at normalized `coords` [B, H, W, 2].

    Every `impl` the JAX package accepts ('gather', 'mxu', 'pallas') maps
    to the one exact warp: kernel A for CUDA tensors, its plain version
    for CPU tensors. The TPU's banded approximations have no counterpart
    here. The gradient flows to `coords` only (kernel A′ on the card);
    `img` is a data frame and must not require grad."""
    if impl not in WARP_IMPLS:
        raise ValueError(f"Unknown warp impl: {impl}")
    return warp_bilinear(img.contiguous(), coords.contiguous())


def in_frame_fraction(coords: torch.Tensor, height: int | None = None) -> torch.Tensor:
    """Fraction of the sample points of normalized `coords` [B, Hg, W, 2]
    that land in the source image, `height` rows tall (default Hg; a band
    of a row-sharded image's coordinates samples the whole image), with
    ops/resample.band_coverage's in-image test of JAX (the row y in [-1,
    H], and here also the column x in [-1, W], in pixels): 0.0 exactly
    when every sample reads the zero padding — the zeros-warp collapse
    that Trainer._warn_if_collapsed reports. A 0-dim fp32 tensor, detached
    (no host sync)."""
    with torch.no_grad():
        _, rows, width, _ = coords.shape
        height = rows if height is None else height
        x = (coords[..., 0] + 1.0) * 0.5 * (width - 1)
        y = (coords[..., 1] + 1.0) * 0.5 * (height - 1)
        inside = (y >= -1.0) & (y <= height) & (x >= -1.0) & (x <= width)
        return inside.float().mean()


def inverse_warp_from_matrix(
    img: torch.Tensor,
    depth: torch.Tensor,
    transform: torch.Tensor,
    intrinsics: torch.Tensor,
    padding_mode: str = "zeros",
    impl: str = "gather",
) -> torch.Tensor:
    """inverse_warp with a pre-assembled [B, 4, 4] rigid transform: NCHW
    `img` [B, C, H, W] sampled at the projection of target-frame `depth`
    [B, H, W] through `transform` and `intrinsics` ([B, 3, 3] or [3, 3])
    -> [B, C, H, W] (kernel A on the card). The warp pads with zeros (the
    reference's mode), the only padding the port's kernel has."""
    if padding_mode != "zeros":
        raise ValueError(f"the port's warp pads with zeros only, not {padding_mode!r}")
    coords = warp_coords(depth, transform, intrinsics)
    return sample_with_impl(img, coords, impl=impl)


def inverse_warp(
    img: torch.Tensor,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    invert_pose: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Warp a source image into the target frame via target depth + pose.

    Args:
      img: [B, C, H, W] source image (where pixels are sampled from).
      depth: [B, H, W] target-frame depth map.
      pose: [B, 6] 6-DoF pose (axis-angle[3], translation[3]),
        target -> source.
      intrinsics: [B, 3, 3] or [3, 3].
      invert_pose: use the inverted pose.
    Returns [B, C, H, W], the source image on the target image plane. The
    transform is built in fp64, as the loss builds it, so the sample
    coordinates are the same bits on every device (see warp_coords).
    """
    transform = pose_matrix(pose.double(), invert=invert_pose)
    return inverse_warp_from_matrix(img, depth, transform, intrinsics,
                                    padding_mode=padding_mode)
