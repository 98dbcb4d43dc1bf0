"""Ranks of tests/test_torch_spatial_uneven.py and
tests/test_torch_spatial_scales.py: gloo process groups on the CPU under a
("data", "spatial") mesh whose row bands differ in height (the 32-row
grain, parallel/mesh.row_bands), spawned by
tests/torch_parallel_worker.start_ranks(..., spatial=s).

Kept out of the test modules (and out of pytest's collection, by its
name) so that a spawned rank imports torch and the port only, not JAX.
"""

import os

import torch

from tests import torch_parallel_worker as worker
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.losses.total import total_loss
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import band
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

BATCH = 2
# name -> (height, width, spatial, depth net kwargs, step settings over
# worker.STEP_SETTINGS and the 'min' objective). The bands: 96 rows over
# 2 are 64 / 32, 80 rows 64 / 16 (80 is no multiple of 32: the last band
# ends off the grain, its encoder levels hold 8, 4, 2, 1 and 1 rows),
# 160 rows over 4 are 64 / 32 / 32 / 32
CASES = {
    "h96": (96, 64, 2, {}, {}),
    "h80_depth_norm": (80, 64, 2, {}, {"depth_norm": True}),
    "h160": (160, 48, 4, {}, {}),
    "remat": (96, 64, 2, {}, {"remat": True}),
    "all_scales_18": (96, 64, 2, {"all_scales": True}, {}),
    "all_scales_50": (96, 64, 2, {"num_layers": 50, "all_scales": True}, {}),
}
BATCH_SEED = 1
# the coarse scales of the upsample unit, on a 96 x 64 image over 2 bands
UPSAMPLE_SHAPE = (96, 64)


def depth_key(name):
    """The weights a case's depth net loads: DispResNet-18's (one scale or
    all; the heads of every scale are always there) or -50's."""
    return "depth50" if CASES[name][3].get("num_layers") == 50 else "depth"


def step_batch(name):
    """Case `name`'s global batch (uint8 images, groundtruth)."""
    height, width = CASES[name][:2]
    return next(SyntheticTripletDataset(1, BATCH, height, width, seed=BATCH_SEED,
                                        uint8_images=True).batches())


def make_state(weights, name):
    """Case `name`'s DispResNet and PoseNet with `weights` ({"depth",
    "depth50", "pose": state dicts}), configs/tpu_v5e.yaml's Adam and a
    StepLR."""
    depth = build_model("DispResNet", device="cpu", **CASES[name][3])
    depth.load_state_dict(weights[depth_key(name)])
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(weights["pose"])
    cfg = config_module.load_config(os.path.join(worker.REPO, "configs", "tpu_v5e.yaml"))
    optimizer = make_optimizer(cfg, depth, pose)
    return TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))


def one_step(weights, name, mesh=None, **overrides):
    """Case `name`'s step on its global batch, under `mesh` when given ->
    worker.step_result."""
    state = make_state(weights, name)
    settings = {**worker.STEP_SETTINGS, "loss_mode": "min", **CASES[name][4], **overrides}
    step = make_train_step(state, device="cpu", mesh=mesh, **settings)
    return worker.step_result(state, step(step_batch(name)))


def steps(mesh, weights, names):
    """The steps of `names` under the mesh (test_torch_spatial_uneven's
    ranks); on ranks other than 0 the gradients as their digest
    (tests/torch_spatial_worker.digest)."""
    from tests.torch_spatial_worker import digest

    out = {name: one_step(weights, name, mesh) for name in names}
    if mesh.rank != 0:
        for result in out.values():
            result["grads"] = digest(result["grads"])
    return out


def multiscale_loss(inputs, mesh=None):
    """total_loss ('min', depth_norm, smoothness on the depth) of four
    disparity scales of `inputs` (this rank's band of each under `mesh`)
    -> (the loss, its parts' automask_keep, and the gradients of the
    disparities of each scale and frame and of the poses)."""
    tgt, refs, poses, intrinsics, disps = inputs
    height = tgt.shape[2]
    leaves = [[d[:, :, band(mesh, height, s)].clone().requires_grad_()
               for s, d in enumerate(frame)] for frame in disps]
    pose_leaf = poses.clone().requires_grad_()
    reproj, smooth, extra = total_loss(tgt, refs, leaves, pose_leaf, intrinsics, mode="min",
                                       smooth_weight=0.01, depth_norm=True, mesh=mesh)
    (reproj + smooth).backward()
    return ((reproj + smooth).detach(), extra["automask_keep"],
            [[d.grad for d in frame] for frame in leaves], pose_leaf.grad)


def data_mesh_steps(mesh, weights, names):
    """The steps of `names` under a data-only mesh of one rank (the
    global-batch BatchNorm of layers._GlobalBatchNorm on the whole batch:
    the one-process step with the mesh's BatchNorm arithmetic)."""
    return {name: one_step(weights, name, mesh) for name in names}


def scale_ranks(mesh, weights, names, upsample_inputs, loss_inputs):
    """The all_scales steps of `names`, the upsample unit and the
    four-scale loss unit (test_torch_spatial_scales)."""
    return {"steps": steps(mesh, weights, names),
            "upsample": worker.band_upsample(mesh, upsample_inputs, UPSAMPLE_SHAPE),
            "loss": multiscale_loss(loss_inputs, mesh)}

