"""Inverse warping: disparity -> depth, sample coordinates, the warp.

Counterpart of unsupervised_pseuso_lidar_tpu/geometry/warp.py
(disp_to_depth :23, depth_to_disp :32, disp_to_depth_ranged :39,
warp_coords :54-109, sample_with_impl :112).
"""

from __future__ import annotations

import torch

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
) -> torch.Tensor:
    """Target-frame depth [B, H, W] + rigid transform [B, 4, 4] +
    intrinsics [B, 3, 3] (or [3, 3]) -> [B, H, W, 2] normalized sample
    coordinates.

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
    _, height, width = depth.shape
    dtype = depth.dtype
    k = intrinsics.double()
    proj = k @ transform[:, :3, :].double()  # [B,3,4]
    m = (proj[:, :, :3] @ torch.linalg.inv(k)).to(dtype)  # K T[:3,:3] K^-1
    t = proj[:, :, 3].to(dtype)  # K T[:3,3]
    u = torch.arange(width, dtype=dtype, device=depth.device)[None, None, :]
    v = torch.arange(height, dtype=dtype, device=depth.device)[None, :, None]

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
