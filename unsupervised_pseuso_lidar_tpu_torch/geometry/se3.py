"""SE(3) algebra for the warp: axis-angle poses -> rigid transforms.

Counterpart of unsupervised_pseuso_lidar_tpu/geometry/se3.py
(is_rotation_matrix :27, euler2mat :43, mat2euler :73, rot_from_axisangle
:101, transformation_from_parameters :153, pose_vec2mat :177, pose_matrix
:192, invert_pose :209). Batched, dtype-preserving.

Conventions: batched rigid transforms are [B, 4, 4]; 6-DoF pose vectors
are [B, 6] = (rx, ry, rz, tx, ty, tz), rotation as axis-angle.
"""

from __future__ import annotations

import torch


def is_rotation_matrix(rot, tol: float = 1e-6) -> torch.Tensor:
    """||R.T R - I||_F < tol per matrix: a bool for [3, 3], [B] bools for
    [B, 3, 3]."""
    rot = torch.as_tensor(rot)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    err = torch.linalg.matrix_norm(rot.transpose(-1, -2) @ rot - eye)
    return err < tol


def euler2mat(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles [..., 3] (x, y, z, radians) -> rotation matrices
    [..., 3, 3], R = Rx @ Ry @ Rz."""
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)

    def mat(*entries):
        return torch.stack(entries, dim=-1).reshape(*x.shape, 3, 3)

    zmat = mat(cz, -sz, zero, sz, cz, zero, zero, zero, one)
    ymat = mat(cy, zero, sy, zero, one, zero, -sy, zero, cy)
    xmat = mat(one, zero, zero, zero, cx, -sx, zero, sx, cx)
    return xmat @ ymat @ zmat


def mat2euler(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> Euler angles [..., 3] (x, y, z) for
    R = Rz @ Ry @ Rx, the OXTS world-pose convention (so not the inverse of
    euler2mat's Rx @ Ry @ Rz); branch-free, batched."""
    sy = torch.sqrt(rot[..., 0, 0] ** 2 + rot[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-rot[..., 1, 2], rot[..., 1, 1]),
                    torch.atan2(rot[..., 2, 1], rot[..., 2, 2]))
    y = torch.atan2(-rot[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy),
                    torch.atan2(rot[..., 1, 0], rot[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (Rodrigues) [B, 3] (or [B, 1, 3]) -> [B, 4, 4]
    rotation-only homogeneous matrices (1e-7 angle regularizer)."""
    if vec.ndim == 3:
        vec = vec[:, 0, :]
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)  # [B,1]
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    c = 1.0 - ca
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]

    zero = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    rows = torch.stack(
        [
            ax * ax * c + ca, ax * ay * c - az * sa, az * ax * c + ay * sa, zero,
            ax * ay * c + az * sa, ay * ay * c + ca, ay * az * c - ax * sa, zero,
            az * ax * c - ay * sa, ay * az * c + ax * sa, az * az * c + ca, zero,
            zero, zero, zero, one,
        ],
        dim=-1,
    )
    return rows.reshape(*ca.shape, 4, 4)


def _translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation [B, 3] -> [B, 4, 4] homogeneous transform."""
    out = torch.eye(4, dtype=t.dtype, device=t.device).expand(
        *t.shape[:-1], 4, 4
    ).clone()
    out[..., :3, 3] = t
    return out


def transformation_from_parameters(
    axisangle: torch.Tensor, translation: torch.Tensor, invert: bool = False
) -> torch.Tensor:
    """(axis-angle, translation) -> [B, 4, 4]: T(t) @ R, or R.T @ T(-t)
    when inverted."""
    if translation.ndim == 3:
        translation = translation[:, 0, :]
    rot = rot_from_axisangle(axisangle)
    if invert:
        rot = rot.transpose(-1, -2)
        translation = -translation
    trans = _translation_matrix(translation)
    return rot @ trans if invert else trans @ rot


def pose_vec2mat(vec: torch.Tensor, mode: str | None = "euler") -> torch.Tensor:
    """6-DoF pose vector [..., 6] (rx, ry, rz, tx, ty, tz) -> [..., 3, 4]
    transform, the rotation from Euler angles (euler2mat); mode None
    returns `vec` unchanged."""
    if mode is None:
        return vec
    if mode != "euler":
        raise ValueError(f"Rotation mode not supported: {mode}")
    return torch.cat([euler2mat(vec[..., :3]), vec[..., 3:, None]], dim=-1)


def invert_pose(transform: torch.Tensor) -> torch.Tensor:
    """Invert [..., 4, 4] rigid transforms: [R|t]^-1 = [R.T | -R.T t]."""
    rot_t = transform[..., :3, :3].transpose(-1, -2)
    t_inv = -(rot_t @ transform[..., :3, 3:])
    top = torch.cat([rot_t, t_inv], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=transform.dtype, device=transform.device
    ).expand(*transform.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def pose_matrix(vec: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """6-DoF pose vector [B, 6] -> [B, 4, 4] (axis-angle rotation first,
    translation last), optionally inverted."""
    pose = transformation_from_parameters(vec[..., :3], vec[..., 3:])
    if invert:
        pose = invert_pose(pose)
    return pose
