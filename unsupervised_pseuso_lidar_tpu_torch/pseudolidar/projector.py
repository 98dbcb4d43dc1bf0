"""Pseudo-LiDAR generation: depth maps -> Velodyne-frame point clouds.

Counterpart of unsupervised_pseuso_lidar_tpu/pseudolidar/projector.py
(depth_to_pointcloud :28, PseudoLiDAR :96, save_cloud :129). The batched
op keeps the static-shape contract: (points [B, H·W, 4], valid [B, H·W])
with the crop and sparsity folded into the mask; project_PL compacts on
the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device


def depth_to_pointcloud(
    depth: torch.Tensor,
    proj: torch.Tensor,
    velo_to_cam: torch.Tensor,
    sparsity: int = 0,
    max_high: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backproject depth images into Velodyne-frame point clouds.

    Args:
      depth: [B, H, W] (or [H, W]) depth in meters (rectified cam 2).
      proj: [3, 4] P_rect_02; velo_to_cam: [4, 4] rigid transform.
      sparsity: keep every k-th pixel index (0 = all).
      max_high: height crop in meters (z_velo < max_high).
    Returns:
      points [B, H·W, 4] (x, y, z, 0) and valid [B, H·W] (x_velo >= 0,
      z_velo < max_high, depth > 0, sparsity).
    """
    if depth.ndim == 2:
        depth = depth[None]
    batch, height, width = depth.shape
    dtype = depth.dtype

    c_u, c_v = proj[0, 2], proj[1, 2]
    f_u, f_v = proj[0, 0], proj[1, 1]
    b_x = proj[0, 3] / (-f_u)
    b_y = proj[1, 3] / (-f_v)

    u = torch.arange(width, dtype=dtype, device=depth.device)[None, None, :]
    v = torch.arange(height, dtype=dtype, device=depth.device)[None, :, None]
    x = (u - c_u) * depth / f_u + b_x
    y = (v - c_v) * depth / f_v + b_y
    cam_points = torch.stack(
        [x, y, depth, torch.ones_like(depth)], dim=-1
    ).reshape(batch, -1, 4)

    cam_to_velo = torch.linalg.inv(velo_to_cam).to(dtype)
    velo = torch.einsum("ij,bnj->bni", cam_to_velo, cam_points)
    # intensity placeholder: clouds are (x, y, z, 0)
    velo = torch.cat([velo[..., :3], torch.zeros_like(velo[..., 3:])], dim=-1)

    # depth > 0 drops no-return pixels, which would backproject to the
    # sensor origin and pass the crop
    valid = (
        (velo[..., 0] >= 0)
        & (velo[..., 2] < max_high)
        & (depth.reshape(batch, -1) > 0)
    )
    if sparsity:
        idx = torch.arange(height * width, device=depth.device)[None, :]
        valid = valid & (idx % sparsity == 0)
    return velo, valid


class PseudoLiDAR:
    """Calibration-bound projector: built from a KITTI calib directory,
    holds P_rect_02 and T_velo_cam on `device`."""

    def __init__(self, calib_dir: str, sparsity: int = 0, max_high: float = 1.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        calib = Calibration(calib_dir)
        self.proj = torch.as_tensor(calib.P, dtype=torch.float32, device=self.device)
        self.velo_to_cam = torch.as_tensor(
            calib.T_velo_cam, dtype=torch.float32, device=self.device
        )
        self.sparsity = int(sparsity)
        self.max_high = float(max_high)

    def project_batch(self, depth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W] depth -> (points [B, H·W, 4], valid [B, H·W])."""
        return depth_to_pointcloud(
            depth.to(self.device, torch.float32), self.proj, self.velo_to_cam,
            sparsity=self.sparsity, max_high=self.max_high,
        )

    def project_PL(self, depth_img: np.ndarray) -> np.ndarray:
        """[H, W] depth -> compacted [N, 4] numpy cloud."""
        points, valid = self.project_batch(torch.as_tensor(depth_img)[None])
        return points[0][valid[0]].cpu().numpy()


def save_cloud(path: str, points: np.ndarray) -> None:
    """Write an [N, 4] cloud, its format by extension: `.bin` is raw
    float32 x/y/z/intensity rows (KITTI's velodyne format, which 3D
    detectors read and geometry/oxts.load_velo_scan reads back), anything
    else numpy's .npy."""
    if path.endswith(".bin"):
        np.ascontiguousarray(points, dtype=np.float32).tofile(path)
    else:
        np.save(path, points)
