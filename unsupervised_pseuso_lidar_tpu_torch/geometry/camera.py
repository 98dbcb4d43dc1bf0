"""Pinhole camera projection and backprojection, batched.

Counterpart of unsupervised_pseuso_lidar_tpu/geometry/camera.py
(pixel_grid :21, backproject :37, project :62, scale_intrinsics :113).
Points are [B, H, W, 3] and sample coordinates [B, H, W, 2], the layout of
the port's sampling grids. The training warp does not go through these
(geometry/warp.warp_coords folds the same chain into one affine map per
job); they are the public pieces of it.
"""

from __future__ import annotations

import torch


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """Homogeneous pixel-coordinate grid [3, H, W] with rows (u, v, 1):
    u in [0, W-1] along axis 2, v in [0, H-1] along axis 1."""
    u = torch.arange(width, dtype=dtype, device=device)
    v = torch.arange(height, dtype=dtype, device=device)
    uu = u[None, :].expand(height, width)
    vv = v[:, None].expand(height, width)
    return torch.stack([uu, vv, torch.ones_like(uu)], dim=0)


def backproject(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Lift depth [B, H, W] to camera-frame points [B, H, W, 3]:
    X = depth · K^-1 (u, v, 1); intrinsics [B, 3, 3] or [3, 3]."""
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None]
    _, height, width = depth.shape
    grid = pixel_grid(height, width, dtype=depth.dtype, device=depth.device)
    k_inv = torch.linalg.inv(intrinsics.to(depth.dtype))
    rays = torch.einsum("bij,jhw->bhwi", k_inv, grid)
    return rays * depth[..., None]


def project(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    transform: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Rigidly transform points [B, H, W, 3] by `transform` [B, 4, 4] and
    project them with `intrinsics` ([B, 3, 3] or [3, 3]) to normalized
    sample coordinates [B, H, W, 2] in [-1, 1] (align_corners: -1 is pixel
    0, +1 pixel W-1 / H-1), with the +eps perspective-divide guard."""
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None]
    _, height, width, _ = points.shape
    dtype = points.dtype
    proj = intrinsics.to(dtype) @ transform[:, :3, :].to(dtype)  # [B, 3, 4]
    cam = (torch.einsum("bik,bhwk->bhwi", proj[:, :, :3], points)
           + proj[:, None, None, :, 3])
    xy = cam[..., :2] / (cam[..., 2:3] + eps)
    scale = torch.tensor([width - 1, height - 1], dtype=dtype, device=points.device)
    return (xy / scale - 0.5) * 2.0


def scale_intrinsics(intrinsics: torch.Tensor, scale_x: float,
                     scale_y: float) -> torch.Tensor:
    """Rescale K for a resized image (row 0 · scale_x, row 1 · scale_y)."""
    scale = torch.tensor([[scale_x], [scale_y], [1.0]], dtype=intrinsics.dtype,
                         device=intrinsics.device)
    return intrinsics * scale
