"""Velodyne scan <-> depth image projection.

Counterpart of unsupervised_pseuso_lidar_tpu/pseudolidar/velo2img.py
(project_velo_to_depth_image :23, project_img_to_velo :79).
project_velo_to_depth_image rasterizes a LiDAR scan into a sparse depth
image (points ahead of the sensor, within max_dist, inside the image) and
keeps the NEAREST depth per pixel: one scatter-min into a buffer filled
with 1e9. It follows its inputs' device. The 3x4 and 4x4 products are
written out as elementwise sums in a fixed order, so the card and the CPU
compute the same coordinates bit for bit; against the JAX package (whose
einsum sums in its own order) a point may land on the neighbouring pixel
when its coordinate is within an ulp of a pixel edge.
"""

from __future__ import annotations

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import depth_to_pointcloud

_BIG = 1e9


def _affine(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, row: int):
    """m[row] · (x, y, z, 1), summed left to right."""
    return m[row, 0] * x + m[row, 1] * y + m[row, 2] * z + m[row, 3]


def project_velo_to_depth_image(
    points: torch.Tensor,
    velo_to_cam: torch.Tensor,
    proj: torch.Tensor,
    width: int,
    height: int,
    max_dist: float = 120.0,
) -> torch.Tensor:
    """Rasterize velodyne points into an [H, W] depth image.

    Args:
      points: [N, 3] or [N, 4] velodyne-frame points (reflectance dropped).
      velo_to_cam: [4, 4] rigid transform; proj: [3, 4] projection matrix.
      width/height: output image size; max_dist: range filter in meters.
    Returns:
      [H, W] float32 depth on the points' device; 0 where no point lands.
    """
    xyz = points[:, :3].float()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    m = velo_to_cam.to(xyz.device, torch.float32)
    p = proj.to(xyz.device, torch.float32)
    dist = torch.sqrt(x * x + y * y + z * z)
    cx, cy, cz = (_affine(m, x, y, z, r) for r in range(3))
    uvw = [_affine(p, cx, cy, cz, r) for r in range(3)]
    u = uvw[0] / uvw[2]
    v = uvw[1] / uvw[2]

    valid = (
        (u >= 0) & (u < width) & (v >= 0) & (v < height)
        & (dist <= max_dist) & (x > 0)
    )
    # truncation toward zero, as the int32 cast in JAX; invalid points
    # carry 1e9, which never wins the minimum
    flat = torch.where(valid, v.to(torch.int64) * width + u.to(torch.int64),
                       torch.zeros_like(u, dtype=torch.int64))
    values = torch.where(valid, cz, torch.full_like(cz, _BIG))
    buffer = torch.full((height * width,), _BIG, dtype=torch.float32, device=xyz.device)
    buffer.scatter_reduce_(0, flat, values, "amin", include_self=True)
    image = torch.where(buffer >= _BIG, torch.zeros_like(buffer), buffer)
    return image.reshape(height, width)


def project_img_to_velo(depth_img, velo_to_cam, proj) -> np.ndarray:
    """The inverse: an [H, W] depth image (numpy or tensor) -> its
    velodyne-frame cloud [N, 4] as numpy (the batched version is
    pseudolidar.projector.depth_to_pointcloud)."""
    depth = torch.as_tensor(depth_img, dtype=torch.float32)
    points, valid = depth_to_pointcloud(
        depth[None],
        torch.as_tensor(proj, dtype=torch.float32, device=depth.device),
        torch.as_tensor(velo_to_cam, dtype=torch.float32, device=depth.device),
    )
    return points[0][valid[0]].cpu().numpy()
