"""Pose / ego-motion evaluation: snippet ATE and geodesic rotation error.

Counterpart of unsupervised_pseuso_lidar_tpu/eval/pose.py (_to_matrices
:45, pose_errors :59, pose_forward :109, make_pose_eval_step :123). Per 3-frame snippet the
predicted translations are scale-aligned to the ground truth by the least-
squares factor s = <t_gt, t_pred> / <t_pred, t_pred> (monocular training
has a global scale ambiguity), and the RMSE over the snippet's transforms
is averaged over the batch; `ate_unscaled` skips the alignment. The
rotation error is the angle of R_pred R_gt^T in degrees. Both the pose
nets and the batches' `oxts` use the warp's convention (axis-angle,
tgt -> ref); 'euler' reads a side as Euler angles (R = Rx Ry Rz).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import euler2mat, pose_matrix


def _to_matrices(poses: torch.Tensor, mode: str):
    """[..., 6] pose vectors -> ([..., 3, 3] rotations, [..., 3] translations)."""
    if mode == "axis_angle":
        # flatten the leading dims first: pose_matrix reads a 3-dim input
        # as [B, 1, 3] and would misread a [B, N, 6] snippet
        lead = poses.shape[:-1]
        mat = pose_matrix(poses.reshape(-1, 6)).reshape(*lead, 4, 4)
        return mat[..., :3, :3], mat[..., :3, 3]
    if mode == "euler":
        return euler2mat(poses[..., :3]), poses[..., 3:]
    raise ValueError(f"Unknown pose convention: {mode!r}")


def pose_errors(
    pred_poses: torch.Tensor,
    gt_poses: torch.Tensor,
    pred_mode: str = "axis_angle",
    gt_mode: str = "axis_angle",
    eps: float = 1e-8,
) -> Dict[str, torch.Tensor]:
    """[B, N, 6] predicted and ground-truth tgt -> ref pose vectors ->
    {'ate', 'ate_unscaled', 'rot_err_deg', 'scale'} as 0-dim float64
    tensors on the inputs' device (ATE in the ground truth's unit; scale is
    the mean least-squares factor).

    The work runs in float64: the rotation error is the arccos of a trace
    next to 3, where one fp32 ulp of the trace moves a sub-degree angle by
    ~1 %, so fp32 would leave the card and the CPU that far apart."""
    rot_p, t_p = _to_matrices(pred_poses.double(), pred_mode)
    rot_g, t_g = _to_matrices(gt_poses.double(), gt_mode)

    num = torch.sum(t_g * t_p, dim=(-2, -1))
    den = torch.clamp(torch.sum(t_p * t_p, dim=(-2, -1)), min=eps)
    scale = num / den  # [B]

    def rmse(diff):  # [B, N, 3] -> [B]
        return torch.sqrt(torch.mean(torch.sum(diff ** 2, dim=-1), dim=-1))

    rel = rot_p @ rot_g.transpose(-1, -2)
    trace = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    return {
        "ate": torch.mean(rmse(scale[..., None, None] * t_p - t_g)),
        "ate_unscaled": torch.mean(rmse(t_p - t_g)),
        "rot_err_deg": torch.mean(torch.rad2deg(torch.arccos(cos))),
        "scale": torch.mean(scale),
    }


def pose_forward(pose_model: nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The pose net on a NORMALIZED NCHW batch -> [B, 2, 6]."""
    refs: Sequence[torch.Tensor] = [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]]
    return pose_model(batch["tgt"], refs)


def make_pose_eval_step(pose_model: nn.Module, semi_sup_pose: bool = False,
                        device: str | torch.device = "cuda"):
    """step(batch) -> pose_errors of the pose net (eval mode) against the
    batch's `oxts`, for host batches of the training schema (uint8 or
    normalized NHWC images). The pose-only surface: the validation step
    computes the same metrics from the pose forward its loss ran. With
    semi_sup_pose the "prediction" is the oxts itself, so every error is
    0 by construction."""
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
        batch_to_device,
        normalize_uint8_batch,
    )
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)

    @torch.no_grad()
    def step(batch) -> Dict[str, torch.Tensor]:
        batch = normalize_uint8_batch(batch_to_device(batch, device))
        if semi_sup_pose:
            poses = batch["oxts"]
        else:
            pose_model.eval()
            poses = pose_forward(pose_model, batch)
        return pose_errors(poses, batch["oxts"])

    return step
