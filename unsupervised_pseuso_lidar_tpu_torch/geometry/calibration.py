"""KITTI calibration parsing (host-side, numpy).

Counterpart of unsupervised_pseuso_lidar_tpu/geometry/calibration.py
(read_calib_file :24, inverse_rigid_transform :53, decompose_projection
:70, Calibration :140), copied because importing that module pulls in jax
through its package __init__.

Exposes, for KITTI raw-format calib directories:
  K          — [3, 3] K_02 camera matrix
  P          — [3, 4] P_rect_02 rectified projection matrix
  R_rect     — [4, 4] homogeneous rectifying rotation (R_rect_02)
  T_velo_cam — [4, 4] velodyne -> reference-camera rigid transform
  T_imu_velo — [4, 4] IMU -> velodyne rigid transform
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

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


def inverse_rigid_transform(transform: np.ndarray) -> np.ndarray:
    """Invert a rigid transform, [R|t]^-1 = [R.T | -R.T t], in float64; a
    3x4 or 4x4 input gives the same shape."""
    transform = np.asarray(transform, dtype=np.float64)
    rot_t = transform[:3, :3].T
    t_inv = -rot_t @ transform[:3, 3]
    out = np.zeros_like(transform)
    out[:3, :3] = rot_t
    out[:3, 3] = t_inv
    if transform.shape[0] == 4:
        out[3, 3] = 1.0
    return out


def decompose_projection(
    proj: np.ndarray,
    front_point: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Factor a 3x4 projection matrix (any projective scale) into
    P ~ K [R | t] -> (K upper-triangular with K[2, 2] = 1 and a positive
    diagonal, R with det +1, t).

    An RQ decomposition of P[:, :3] through numpy's QR of the row- and
    column-reversed matrix, the signs fixed so diag(K) > 0 and det(R) = +1,
    then t = K^-1 P[:, 3]. When `front_point`, a world point known to lie in
    front of the camera, lands behind it, the factors are chirality-flipped
    (D = diag(-1, 1, -1) into K and R, overall scale -1): fx > 0 stays,
    fy turns negative, R stays a rotation.
    """
    proj = np.asarray(proj, dtype=np.float64).reshape(3, 4)
    m = proj[:, :3]
    rev = np.eye(3)[::-1]
    q, r = np.linalg.qr((rev @ m).T)
    k = rev @ r.T @ rev
    rot = rev @ q.T
    # diag(K) positive; the sign flips go into R (sign is its own inverse)
    sign = np.diag(np.sign(np.diag(k)))
    k = k @ sign
    rot = sign @ rot
    # det(R) = +1: negating R and t flips P's projective scale, the same camera
    if np.linalg.det(rot) < 0:
        rot = -rot
        sign_t = -1.0
    else:
        sign_t = 1.0
    t = np.linalg.solve(k, sign_t * proj[:, 3])
    k = k / k[2, 2]
    if front_point is not None:
        z = rot[2] @ np.asarray(front_point, np.float64) + t[2]
        if z < 0:
            d = np.diag([-1.0, 1.0, -1.0])
            k = -(k @ d)
            rot = d @ rot
            t = d @ t
    return k, rot, t


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
