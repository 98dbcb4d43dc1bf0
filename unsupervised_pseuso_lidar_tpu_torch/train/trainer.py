"""Validation step: models forward + the photometric objective, no grads.

Counterpart of the eval part of unsupervised_pseuso_lidar_tpu/train/
trainer.py (forward_batch :164, normalize_uint8_batch :213,
make_eval_step :480). The training step comes with the training slice;
ground-truth depth and pose metrics with the evaluation slice, so the eval
step ignores `groundtruth` and `oxts` in a batch.

Batches use the JAX package's schema and layout — tgt [B, H, W, 3],
ref_imgs [B, 2, H, W, 3] (uint8 or ImageNet-normalized float),
intrinsics [B, 3, 3] — as numpy arrays or tensors; `batch_to_device`
moves them to the device as NCHW tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import disp_to_depth
from unsupervised_pseuso_lidar_tpu_torch.losses.total import total_loss
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)


def batch_to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """{tgt [B,H,W,3], ref_imgs [B,2,H,W,3], intrinsics} (numpy or
    tensors) -> tensors on `device`: tgt [B,3,H,W], ref_imgs [B,2,3,H,W].
    uint8 images stay uint8 (a quarter of the fp32 bytes to copy)."""
    def to(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)

    tgt = to(batch["tgt"]).to(device, non_blocking=True)
    refs = to(batch["ref_imgs"]).to(device, non_blocking=True)
    return {
        "tgt": tgt.permute(0, 3, 1, 2).contiguous(),
        "ref_imgs": refs.permute(0, 1, 4, 2, 3).contiguous(),
        "intrinsics": to(batch["intrinsics"]).to(device, torch.float32),
    }


def normalize_uint8_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 NCHW image batch -> ImageNet-normalized float32 (float input
    passes through unchanged)."""
    if batch["tgt"].dtype != torch.uint8:
        return batch
    device = batch["tgt"].device
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=device)[:, None, None]

    def norm(x):
        return (x.float() / 255.0 - mean) / std

    return dict(batch, tgt=norm(batch["tgt"]), ref_imgs=norm(batch["ref_imgs"]))


def forward_batch(
    depth_model: nn.Module, pose_model: nn.Module, batch: Dict[str, torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Depth (tgt and ref0 stacked into one 2B pass) and pose forward on a
    normalized NCHW batch -> (disps_tgt, disps_ref0, poses)."""
    tgt = batch["tgt"]
    ref0 = batch["ref_imgs"][:, 0]
    ref1 = batch["ref_imgs"][:, 1]
    bsz = tgt.shape[0]
    disps = depth_model(torch.cat([tgt, ref0], dim=0))
    disps_tgt = [d[:bsz] for d in disps]
    disps_ref0 = [d[bsz:] for d in disps]
    poses = pose_model(tgt, [ref0, ref1])
    return disps_tgt, disps_ref0, poses


class EvalStep:
    """step(batch) -> ({"loss": scalar tensor}, depth_pred [B, H, W]).

    The models run in eval mode, under bf16 autocast when precision is
    'bf16'; their outputs are cast to fp32 before the loss, which always
    runs in fp32. As in the JAX eval step, the loss takes total_loss'
    defaults for everything but the mode and depth_norm: smoothness on the
    (normalized, with depth_norm) depth at weight 1.0 — not the training
    config's smoothness settings — and the bidirectional automask."""

    def __init__(self, depth_model: nn.Module, pose_model: nn.Module,
                 loss_mode: str = "min", depth_norm: bool = False,
                 precision: str = "fp32", device: str | torch.device = "cuda"):
        if precision not in ("fp32", "bf16"):
            raise ValueError("precision must be 'fp32' or 'bf16'")
        self.device = resolve_device(device)
        self.depth_model = depth_model.eval()
        self.pose_model = pose_model.eval()
        self.loss_mode = loss_mode
        self.depth_norm = depth_norm
        self.precision = precision

    @torch.no_grad()
    def loss_inputs(self, batch: Dict) -> Dict:
        """The fp32 tensors the loss consumes: normalized images, the two
        disparity lists, poses and intrinsics."""
        batch = normalize_uint8_batch(batch_to_device(batch, self.device))
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=self.precision == "bf16"):
            disps_tgt, disps_ref0, poses = forward_batch(
                self.depth_model, self.pose_model, batch
            )
        return {
            "tgt": batch["tgt"],
            "refs": [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]],
            "disparities": [[d.float() for d in disps_tgt],
                            [d.float() for d in disps_ref0]],
            "poses": poses.float(),
            "intrinsics": batch["intrinsics"],
        }

    @torch.no_grad()
    def loss(self, inputs: Dict) -> torch.Tensor:
        reproj, smooth = total_loss(
            inputs["tgt"], inputs["refs"], inputs["disparities"],
            inputs["poses"], inputs["intrinsics"], mode=self.loss_mode,
            depth_norm=self.depth_norm,
        )
        return reproj + smooth

    def __call__(self, batch: Dict):
        inputs = self.loss_inputs(batch)
        depth_pred = disp_to_depth(inputs["disparities"][0][0][:, 0])
        return {"loss": self.loss(inputs)}, depth_pred


def make_eval_step(depth_model: nn.Module, pose_model: nn.Module,
                   loss_mode: str = "min", depth_norm: bool = False,
                   precision: str = "fp32",
                   device: str | torch.device = "cuda") -> EvalStep:
    """Build the validation step (see EvalStep)."""
    return EvalStep(depth_model, pose_model, loss_mode=loss_mode,
                    depth_norm=depth_norm, precision=precision, device=device)
