"""KITTI calibration parsing (host-side, numpy).

Counterpart of unsupervised_pseuso_lidar_tpu/geometry/calibration.py
(read_calib_file, Calibration), copied because importing that module pulls
in jax through its package __init__.

Exposes, for KITTI raw-format calib directories:
  K          — [3, 3] K_02 camera matrix
  P          — [3, 4] P_rect_02 rectified projection matrix
  R_rect     — [4, 4] homogeneous rectifying rotation (R_rect_02)
  T_velo_cam — [4, 4] velodyne -> reference-camera rigid transform
  T_imu_velo — [4, 4] IMU -> velodyne rigid transform
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_calib_file(filepath: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI calibration text file into {key: float array};
    non-numeric values (dates) are skipped."""
    data: Dict[str, np.ndarray] = {}
    with open(filepath, "r") as f:
        for line in f:
            line = line.rstrip()
            if not line or ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def transform_from_rot_trans(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """[R|t] -> 4x4 homogeneous transform."""
    rot = np.asarray(rot, dtype=np.float64).reshape(3, 3)
    trans = np.asarray(trans, dtype=np.float64).reshape(3, 1)
    return np.vstack((np.hstack([rot, trans]), [0.0, 0.0, 0.0, 1.0]))


class Calibration:
    """KITTI raw calibration bundle for one drive date.

    Args:
      calib_dir: directory (or prefix) containing calib_velo_to_cam.txt,
        calib_cam_to_cam.txt, and calib_imu_to_velo.txt.
    """

    def __init__(self, calib_dir: str):
        self.calib_dir = calib_dir

        def path(name: str) -> str:
            candidate = os.path.join(calib_dir, name)
            # tolerate prefix-style paths ("…/2011_09_26" + "calib_x.txt")
            if not os.path.exists(candidate) and os.path.exists(calib_dir + name):
                candidate = calib_dir + name
            return candidate

        velo_to_cam = read_calib_file(path("calib_velo_to_cam.txt"))
        cam_to_cam = read_calib_file(path("calib_cam_to_cam.txt"))
        imu_to_velo = read_calib_file(path("calib_imu_to_velo.txt"))

        self.K = cam_to_cam["K_02"].reshape(3, 3)
        self.P = cam_to_cam["P_rect_02"].reshape(3, 4)
        self.R_rect = transform_from_rot_trans(
            cam_to_cam["R_rect_02"], np.zeros(3)
        )
        self.T_velo_cam = transform_from_rot_trans(
            velo_to_cam["R"], velo_to_cam["T"]
        )
        self.T_imu_velo = transform_from_rot_trans(
            imu_to_velo["R"], imu_to_velo["T"]
        )

    @property
    def imu_to_cam(self) -> np.ndarray:
        """Composite IMU -> rectified-camera transform."""
        return self.R_rect @ self.T_velo_cam @ self.T_imu_velo

    @property
    def intrinsics(self) -> np.ndarray:
        """[3, 3] intrinsics of the rectified camera 2 (P[:, :3])."""
        return self.P[:, :3].copy()
