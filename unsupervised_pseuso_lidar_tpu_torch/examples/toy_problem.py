"""Toy problem: depth-only training in a controlled-geometry scene.

Counterpart of the JAX package's examples/toy_problem.py (run :22-101).
The oracle is the synthetic plane scene with exactly known depth and
poses. The pose network is bypassed (ground-truth poses, the
semi_sup_pose path), so ONLY the depth net trains: if the geometry stack
is right, the predicted depth converges toward the plane's depth.

The step is the port's TrainStep with the script's settings; on the card
it runs captured (train/graph.py), as every step without a mesh does.
Its default 'mean' objective launches kernels A and A′ once a step.

Usage: python -m unsupervised_pseuso_lidar_tpu_torch.examples.toy_problem
[--steps 200] (on the card; run(device="cpu") trains on the CPU)
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import synthetic_triplet_batch
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import disp_to_depth
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    TrainStep,
    batch_to_device,
    create_train_state,
    make_train_step,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device


def toy_config(batch: int = 4, height: int = 64, width: int = 96) -> Config:
    """The JAX script's config: DispResNet + PoseNet, Adam at 1e-4 for both,
    disparity smoothness at 1e-3 with ground-truth poses."""
    return Config.from_dict(
        {
            "model": {
                "name": "toy",
                "depth": {"name": "DispResNet"},
                "pose": {"name": "PoseNet"},
            },
            "datasets": {
                "augmentation": {"image_width": width, "image_height": height},
                "sequence_length": 3,
            },
            "action": {
                "batch_size": batch,
                "semi_sup_pose": True,
                # a well-conditioned objective for the depth-only oracle:
                # disparity smoothness at monodepth2's weight
                "smooth_on": "disp",
                "smooth_weight": 1e-3,
                "optimizer": {"depth": {"lr": 1e-4}, "pose": {"lr": 1e-4}},
            },
        }
    )


def make_toy_step(state: TrainState, device: str | torch.device = "cuda") -> TrainStep:
    """The script's train step over `state`: ground-truth poses, disparity
    smoothness at 1e-3, the default 'mean' objective."""
    return make_train_step(state, device, semi_sup_pose=True, smooth_on="disp",
                           smooth_weight=1e-3)


def toy_batch(batch: int, height: int, width: int, seed: int, scene_depth: float,
              cam_tx: float) -> Dict[str, np.ndarray]:
    """Step `seed`'s batch: the synthetic triplets without their ground
    truth, which the step does not read."""
    raw = synthetic_triplet_batch(batch, height, width, seed=seed, depth=scene_depth,
                                  tx=cam_tx)
    return {k: v for k, v in raw.items() if k != "groundtruth"}


@torch.no_grad()
def depth_error(depth_model: nn.Module, batch: Dict, scene_depth: float,
                device: str | torch.device = "cuda") -> float:
    """mean |depth − scene_depth| of the eval-mode forward on the batch's
    target frames, depth = disp_to_depth (scale 0): the JAX script's
    depth_error."""
    tgt = batch_to_device(batch, torch.device(device))["tgt"]
    depth_model.eval()
    disps = depth_model(tgt)
    depth = disp_to_depth(disps[0][:, 0])
    return float(torch.abs(depth - scene_depth).mean())


def run(steps: int = 200, batch: int = 4, height: int = 64, width: int = 96,
        scene_depth: float = 10.0, cam_tx: float = 0.01, verbose: bool = True,
        device: str | torch.device = "cuda") -> List[float]:
    """Train `steps` steps; returns mean |depth − scene_depth| after the
    first step and after every tenth of the run, as the JAX script does.

    cam_tx is small so that the initial warp displacement (at the
    network's untrained depth, ~0.2 m) stays inside the photometric basin
    of attraction (under half the texture period): with a large baseline
    the local gradient beyond the texture's correlation length is noise
    and the disparity collapses."""
    device = resolve_device(device)
    config = toy_config(batch, height, width)
    state = create_train_state(config, torch.Generator().manual_seed(0),
                               steps_per_epoch=steps, device=device)
    step = make_toy_step(state, device)
    errors = []
    for i in range(steps):
        data = toy_batch(batch, height, width, i, scene_depth, cam_tx)
        metrics = step(data)
        if i == 0 or (i + 1) % max(steps // 10, 1) == 0:
            err = depth_error(state.depth_model, data, scene_depth, device)
            errors.append(err)
            if verbose:
                print(f"step {i + 1:4d} loss={float(metrics['loss']):.4f} "
                      f"mean |depth - {scene_depth}| = {err:.3f} m")
    return errors


def main(argv=None) -> List[float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args(argv)
    errors = run(steps=args.steps)
    improved = errors[-1] < errors[0]
    print(f"depth error {errors[0]:.3f} -> {errors[-1]:.3f} m "
          f"({'improved' if improved else 'NOT improved'})")
    return errors


if __name__ == "__main__":
    main()
