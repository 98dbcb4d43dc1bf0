"""Plain PyTorch reference of the pseudo-LiDAR projector (Wang et al.,
"Pseudo-LiDAR from Visual Depth Estimation", CVPR 2019; the KITTI
backprojection of its `calib.project_image_to_velo`), in float64.

A depth map's pixels are backprojected through the rectified camera
P_rect_02 (with its baseline offsets), moved into the Velodyne frame by
the inverse of the velodyne -> camera transform, and kept where x >= 0
(ahead of the sensor), z < max_high and the depth is positive. The cloud
is the kept points (x, y, z, 0) in pixel order.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def camera(calib: Dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P_rect_02 [3, 4], the velodyne -> camera transform [4, 4]) of a
    calibration (row-major R and T), in float64."""
    proj = torch.tensor(calib["P_rect_02"], dtype=torch.float64, device=device).reshape(3, 4)
    to_cam = torch.eye(4, dtype=torch.float64, device=device)
    to_cam[:3, :3] = torch.tensor(calib["velo_to_cam_R"], dtype=torch.float64).reshape(3, 3)
    to_cam[:3, 3] = torch.tensor(calib["velo_to_cam_T"], dtype=torch.float64)
    return proj, to_cam


def backproject(depth: torch.Tensor, calib: Dict, max_high: float):
    """depth [H, W] (metres) -> (every pixel's velodyne point [3, H*W], its
    signed distance in metres into the kept region, min(x, max_high - z),
    -inf where the depth is not positive)."""
    proj, to_cam = camera(calib, depth.device)
    height, width = depth.shape
    d = depth.double()
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=d.device),
                          torch.arange(width, dtype=torch.float64, device=d.device),
                          indexing="ij")
    f_u, f_v = proj[0, 0], proj[1, 1]
    x = (u - proj[0, 2]) * d / f_u + proj[0, 3] / (-f_u)
    y = (v - proj[1, 2]) * d / f_v + proj[1, 3] / (-f_v)
    to_velo = torch.linalg.inv(to_cam)
    velo = to_velo[:3, :3] @ torch.stack([x, y, d]).reshape(3, -1) + to_velo[:3, 3:]
    inside = torch.minimum(velo[0], max_high - velo[2])
    inside = torch.where(d.reshape(-1) > 0, inside, torch.full_like(inside, -math.inf))
    return velo, inside

