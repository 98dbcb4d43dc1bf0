"""Trajectory integration and the KITTI odometry file format (host, float64).

Counterpart of unsupervised_pseuso_lidar_tpu/eval/trajectory.py
(relative_matrices :73, integrate_relative_poses :92, kitti_odometry_lines
:113), copied because the port imports nothing of the JAX package. The
pose net's relative transforms are composed into camera-to-world poses and
written as KITTI odometry lines (the flattened 3x4 [R|t] of camera k in
camera 0's frame, 12 numbers a line).

Convention: a relative 6-vector (tgt -> ref) maps TGT-frame points into
the REF frame, X_ref = R X_tgt + t (the warp's convention), so the world
pose composes as P_ref = P_tgt @ inv(T).
"""

from __future__ import annotations

from typing import List

import numpy as np


def _rot_from_axisangle64(vec: np.ndarray) -> np.ndarray:
    """[N, 3] float64 axis-angle -> [N, 3, 3] Rodrigues rotations,
    R = I + a·K + b·K² with K = skew(vec), a = sin(t)/t, b = (1 - cos t)/t²,
    series-expanded below t = 1e-8."""
    vec = np.asarray(vec, np.float64)
    theta = np.linalg.norm(vec, axis=-1)
    t2 = theta * theta
    small = theta < 1e-8
    safe_t = np.where(small, 1.0, theta)
    a = np.where(small, 1.0 - t2 / 6.0, np.sin(safe_t) / safe_t)
    b = np.where(small, 0.5 - t2 / 24.0, (1.0 - np.cos(safe_t)) / (safe_t**2))
    x, y, z = vec[:, 0], vec[:, 1], vec[:, 2]
    zero = np.zeros_like(x)
    k = np.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], axis=-1
    ).reshape(-1, 3, 3)
    return (
        np.eye(3)[None]
        + a[:, None, None] * k
        + b[:, None, None] * (k @ k)
    )


def _euler2mat64(angles: np.ndarray) -> np.ndarray:
    """[N, 3] float64 (x, y, z) angles -> R = Rx @ Ry @ Rz."""
    angles = np.asarray(angles, np.float64)
    x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    zero, one = np.zeros_like(x), np.ones_like(x)
    zmat = np.stack(
        [cz, -sz, zero, sz, cz, zero, zero, zero, one], axis=-1
    ).reshape(-1, 3, 3)
    ymat = np.stack(
        [cy, zero, sy, zero, one, zero, -sy, zero, cy], axis=-1
    ).reshape(-1, 3, 3)
    xmat = np.stack(
        [one, zero, zero, zero, cx, -sx, zero, sx, cx], axis=-1
    ).reshape(-1, 3, 3)
    return xmat @ ymat @ zmat


def relative_matrices(rel6: np.ndarray, mode: str) -> np.ndarray:
    """[N, 6] relative vectors -> [N, 4, 4] transforms, in float64 (the
    links feed a long product chain)."""
    rel6 = np.asarray(rel6, np.float64)
    if mode == "axis_angle":
        rot = _rot_from_axisangle64(rel6[:, :3])
    elif mode == "euler":
        rot = _euler2mat64(rel6[:, :3])
    else:
        raise ValueError(f"Unknown pose convention: {mode!r}")
    mats = np.tile(np.eye(4), (len(rel6), 1, 1))
    mats[:, :3, :3] = rot
    mats[:, :3, 3] = rel6[:, 3:]
    return mats


def integrate_relative_poses(
    rel6: np.ndarray, mode: str = "axis_angle"
) -> np.ndarray:
    """[N, 6] successive (t -> t+1) vectors -> [N+1, 4, 4] world poses:
    P_0 = I, P_{k+1} = P_k @ inv(T_{k -> k+1}), accumulated in float64."""
    mats = relative_matrices(rel6, mode)
    poses = np.empty((len(mats) + 1, 4, 4))
    poses[0] = np.eye(4)
    for k, t_rel in enumerate(mats):
        rot_t = t_rel[:3, :3].T
        inv = np.eye(4)
        inv[:3, :3] = rot_t
        inv[:3, 3] = -rot_t @ t_rel[:3, 3]
        poses[k + 1] = poses[k] @ inv
    return poses


def kitti_odometry_lines(poses: np.ndarray) -> List[str]:
    """[N, 4, 4] world poses -> KITTI odometry lines (3x4 row-major)."""
    return [
        " ".join(f"{v:.9e}" for v in pose[:3, :4].reshape(-1))
        for pose in np.asarray(poses)
    ]
