"""Ground-truth depth rasterized from raw velodyne scans (host stage).

Counterpart of unsupervised_pseuso_lidar_tpu/data/velo_gt.py
(velo_path_for_image :23, depth_gt_from_velo :30). When a split line has
no annotated-depth column, sparse ground truth comes from the drive's
velodyne_points/*.bin scan through P_rect_02 @ R_rect @ T_velo_cam. The
rasterizer runs on CPU tensors here: it is exact (a scatter-min), it runs
inside the loader's workers, and a forked worker must never touch CUDA.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.geometry.oxts import load_velo_scan
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.velo2img import (
    project_velo_to_depth_image,
)


def velo_path_for_image(image_path: str) -> str:
    """image_02/data/xxx.png -> velodyne_points/data/xxx.bin."""
    frame = os.path.splitext(os.path.basename(image_path))[0]
    drive_dir = os.path.dirname(os.path.dirname(os.path.dirname(image_path)))
    return os.path.join(drive_dir, "velodyne_points", "data", frame + ".bin")


def depth_gt_from_velo(
    velo_file: str,
    calib: Calibration,
    width: int,
    height: int,
    max_dist: float = 120.0,
    orig_size: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Rasterize one velodyne scan into an [H, W] float32 sparse depth
    image (0 = no return, as in data_depth_annotated).

    orig_size: (orig_h, orig_w) of the camera frame the calibration
    describes. When the output size differs, the projection's rows are
    scaled so that points land on the resized grid: depths are metric
    and are never interpolated."""
    scan = load_velo_scan(velo_file)
    velo_to_rect = calib.R_rect @ calib.T_velo_cam
    proj = calib.P.astype(np.float32).copy()
    if orig_size is not None:
        orig_h, orig_w = orig_size
        proj[0] *= width / orig_w
        proj[1] *= height / orig_h
    img = project_velo_to_depth_image(
        torch.from_numpy(scan[:, :3]),
        torch.from_numpy(velo_to_rect.astype(np.float32)),
        torch.from_numpy(proj),
        width=width, height=height, max_dist=max_dist,
    )
    return img.numpy()
