"""Real-image learning evidence: depth-only training on the dinosaur
turntable (36 photographs with calibrated projection matrices).

Counterpart of the JAX package's examples/dino_turntable.py (_axis_angle
:37, load_dino :61, run :152). The cameras are RQ-factored by the port's
decompose_projection (with the chirality fix the Oxford cameras need),
the ground-truth relative poses go through the semi_sup_pose path and the
step is the port's TrainStep (captured on the card): depth is the only
thing learned, so photometric convergence on real images exercises the
whole geometry, loss and kernel stack. Its 'mean' objective launches
kernels A and A′ once a step; warp_err launches A once a call.

The data is read in place from DINO_ROOT (images/viff.NNN.ppm,
utils/dino_Ps.mat) and never copied; without it, or without scipy, run
prints the JAX script's skip message and returns None.

Usage: python -m unsupervised_pseuso_lidar_tpu_torch.examples.dino_turntable
[--steps 400] (on the card; run(device="cpu") trains on the CPU)
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import decompose_projection
from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import pose_matrix
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    disp_to_depth,
    inverse_warp_from_matrix,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.total import normalize_depth
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    TrainStep,
    batch_to_device,
    create_train_state,
    make_train_step,
    normalize_uint8_batch,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

# the JAX script's data root (its :33), under the reference snapshot its
# skip message names; run reads the module's DINO_ROOT when it is called
REFERENCE_ROOT = "/root/reference"
DINO_ROOT = os.path.join(REFERENCE_ROOT, "notes", "toy_problem")
# the reference crops the frames to their first 650 columns before its
# transforms
CROP_WIDTH = 650
# a world point in front of every camera: the object sits on the
# turntable's axis at about (0, 0, -0.66)
FRONT_POINT = (0.0, 0.0, -0.6582)


def _axis_angle(rot: np.ndarray) -> np.ndarray:
    """SO(3) log map on the host: rotation matrix -> axis · angle."""
    cos = np.clip((np.trace(rot) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos)
    if angle < 1e-8:
        return np.zeros(3)
    axis = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                     rot[1, 0] - rot[0, 1]]) / (2.0 * np.sin(angle))
    return axis * angle


def load_dino(height: int = 192, width: int = 256, root: str = DINO_ROOT
              ) -> Optional[Dict[str, np.ndarray]]:
    """Triplets over the whole turntable sequence, shaped like
    synthetic_triplet_batch's: uint8 tgt [N − 2, H, W, 3] and ref_imgs
    [N − 2, 2, H, W, 3] (frames t − 1 and t + 1), intrinsics [N − 2, 3, 3]
    and oxts [N − 2, 2, 6] (the ground-truth tgt -> ref poses, axis-angle
    and translation), fp32; None without the dataset or scipy."""
    try:
        from PIL import Image
        from scipy.io import loadmat
    except ImportError:
        return None
    mat = os.path.join(root, "utils", "dino_Ps.mat")
    if not os.path.exists(mat):
        return None

    projections = loadmat(mat)["P"]
    num = projections.shape[1]
    front = np.array(FRONT_POINT)
    cams = [decompose_projection(np.asarray(projections[0, i]), front_point=front)
            for i in range(num)]

    imgs = []
    src_h = None
    for i in range(num):
        img = Image.open(os.path.join(root, "images", f"viff.{i:03d}.ppm"))
        if src_h is None:
            src_h = img.size[1]
        elif img.size[1] != src_h:
            raise ValueError(
                f"frame {i} height {img.size[1]} != {src_h}: the shared "
                "intrinsics rescale assumes a constant frame size")
        img = img.crop((0, 0, CROP_WIDTH, src_h)).resize((width, height), Image.BILINEAR)
        imgs.append(np.asarray(img, np.uint8))
    imgs = np.stack(imgs)
    scale = np.diag([width / CROP_WIDTH, height / src_h, 1.0])

    def pose(cam):
        out = np.eye(4)
        out[:3, :3], out[:3, 3] = cam[1], cam[2]
        return out

    tgts, refs, intr, oxts = [], [], [], []
    for t in range(1, num - 1):
        pose_t = pose(cams[t])
        vecs = []
        for r in (t - 1, t + 1):
            rel = pose(cams[r]) @ np.linalg.inv(pose_t)  # x_ref = rel @ x_tgt
            vecs.append(np.concatenate([_axis_angle(rel[:3, :3]), rel[:3, 3]]))
        tgts.append(imgs[t])
        refs.append(np.stack([imgs[t - 1], imgs[t + 1]]))
        intr.append(scale @ cams[t][0])
        oxts.append(np.stack(vecs))
    return {
        "tgt": np.stack(tgts),
        "ref_imgs": np.stack(refs),
        "intrinsics": np.stack(intr).astype(np.float32),
        "oxts": np.stack(oxts).astype(np.float32),
    }


def dino_config(batch: int = 8, height: int = 192, width: int = 256) -> Config:
    """The JAX script's config: DispResNet + PoseNet at the given size."""
    return Config.from_dict(
        {
            "model": {
                "name": "dino",
                "depth": {"name": "DispResNet"},
                "pose": {"name": "PoseNet"},
            },
            "datasets": {"augmentation": {"image_width": width, "image_height": height}},
            "action": {"batch_size": batch, "learning_rate": 1e-4},
        }
    )


def make_dino_step(state: TrainState, device: str | torch.device = "cuda") -> TrainStep:
    """The script's train step: ground-truth poses, disparity smoothness
    at 1e-3, per-image mean-normalized depth (depth_norm). The turntable's
    metric scale is ~1 unit, far from disp_to_depth's ~0.2 at a fresh
    init, where every raw-depth warp sample would land out of frame;
    normalized depth warps at scale ~1 from the first step, and the
    ground-truth poses are already in the scene's units. (JAX's script
    asks for its exact gather warp; the port's every warp is kernel A,
    exact.)"""
    return make_train_step(state, device, semi_sup_pose=True, smooth_on="disp",
                           smooth_weight=1e-3, depth_norm=True)


@torch.no_grad()
def warp_err(depth_model: nn.Module, batch: Dict, device: str | torch.device = "cuda"):
    """(mean |tgt − warp| on the valid pixels, the signed (tgt − warp).mean()
    over every pixel) of ref0 warped into the target frame (kernel A on the
    card), on [0, 1]-scaled images, at the eval-mode depth normalized as
    the objective normalizes it and the ground-truth pose: the JAX
    script's warp_err, as 0-dim tensors. The signed mean is the
    reference's literal recorded statistic, 0.00699 on its trained KITTI
    model; positive and negative residuals cancel in it, so the |·| on
    valid pixels is reported beside it. Eager: it runs once every 100
    steps, so a graph of it would hardly be replayed."""
    device = torch.device(device)
    b = batch_to_device(batch, device)
    img = b["tgt"].float() / 255.0
    ref = b["ref_imgs"][:, 0].float() / 255.0
    depth_model.eval()
    disps = depth_model(normalize_uint8_batch(b)["tgt"])
    depth = normalize_depth(disp_to_depth(disps[0][:, 0]))
    # fp64, as the loss builds its transforms (losses/reprojection.py)
    transform = pose_matrix(b["oxts"][:, 0].double())
    warped = inverse_warp_from_matrix(ref, depth, transform, b["intrinsics"])
    valid = (torch.abs(warped).sum(1, keepdim=True) > 0).float()
    abs_err = torch.sum(torch.abs(warped - img) * valid) / (torch.sum(valid) * 3.0)
    signed_err = torch.mean(img - warped)
    return abs_err, signed_err


def run(steps: int = 400, batch: int = 8, height: int = 192, width: int = 256,
        verbose: bool = True, trajectory: bool = False,
        device: str | torch.device = "cuda"):
    """Depth-only fit on the turntable; returns the (initial, final)
    warp_err |·| statistic, or with trajectory (initial, final, [(step,
    abs_err, signed_err), ...]) at step 0 and every 100 steps; None when
    the data is unavailable."""
    device = resolve_device(device)
    data = load_dino(height, width, DINO_ROOT)
    if data is None:
        print(f"dino dataset unavailable (needs {REFERENCE_ROOT} and scipy)")
        return None
    num = data["tgt"].shape[0]

    config = dino_config(batch, height, width)
    state = create_train_state(config, torch.Generator().manual_seed(0), 1000, device)
    step = make_dino_step(state, device)
    batches = [{k: v[start:start + batch] for k, v in data.items()}
               for start in range(0, num - batch + 1, batch)]

    def errors():
        e = warp_err(state.depth_model, batches[0], device)
        return float(e[0]), float(e[1])

    err0, signed0 = errors()
    curve = [(0, round(err0, 5), round(signed0, 5))]
    for i in range(steps):
        metrics = step(batches[i % len(batches)])
        if (i + 1) % 100 == 0:
            err_i, signed_i = errors()
            curve.append((i + 1, round(err_i, 5), round(signed_i, 5)))
            if verbose:
                print(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                      f"warp_err={err_i:.5f} signed={signed_i:.5f}", flush=True)
    err1, signed1 = errors()
    if verbose:
        print(f"dino warp |tgt-warp| mean (valid px): {err0:.5f} -> {err1:.5f}; "
              f"reference-statistic signed mean (tgt-warp).mean(): {signed0:.5f} -> "
              f"{signed1:.5f} (reference's recorded KITTI value of the same "
              f"expression: 0.00699, images/warping.txt:1)")
    if trajectory:
        return err0, err1, curve
    return err0, err1


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=400)
    args = parser.parse_args(argv)
    return run(steps=args.steps)


if __name__ == "__main__":
    main()
