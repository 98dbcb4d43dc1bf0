"""Ranks of tests/test_torch_spatial.py: gloo process groups on the CPU
under a ("data", "spatial") mesh, spawned by
tests/torch_parallel_worker.run_ranks(..., spatial=2).

Kept out of the test module (and out of pytest's collection, by its name)
so that a spawned rank imports torch and the port only, not JAX.
"""

import hashlib
import os
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

from tests import torch_parallel_worker as worker
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import photometric_loss
from unsupervised_pseuso_lidar_tpu_torch.losses.smoothness import smooth_loss
from unsupervised_pseuso_lidar_tpu_torch.losses.total import normalize_depth, total_loss
from unsupervised_pseuso_lidar_tpu_torch.models import layers
from unsupervised_pseuso_lidar_tpu_torch.models.depth.bts import BtsModel
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import make_mesh, shard_batch
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import band, check_height
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.utils import visualization
from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    bind_spatial,
    make_eval_step,
    make_lr_schedule,
    make_multi_step,
    make_optimizer,
    make_train_step,
)

HEIGHT, WIDTH, BATCH = worker.HEIGHT, worker.WIDTH, worker.BATCH
# name -> (batch seed, pose net, step settings over worker.STEP_SETTINGS);
# 'supervised' zeroes the ground truth of images 2-3 in the top half, so
# the data rows and the bands hold different numbers of LiDAR returns.
# 'augment' takes batch seed 1: at seed 3 every mesh, data-only as well,
# differs from the one-process step by the same 2.1e-4 gradient rel L2 (a
# pixel crossing that the mesh path's fp64 BatchNorm sums and
# F.batch_norm's fp32 ones put on either side), where seed 1 gives 4.4e-5
STEP_CASES = {
    "min_posefc_depth_norm": (1, "PoseFc", dict(loss_mode="min", depth_norm=True)),
    "min": (1, "PoseNet", dict(loss_mode="min")),
    "mean": (1, "PoseNet", dict(loss_mode="mean")),
    "ssim": (1, "PoseNet", dict(loss_mode="ssim")),
    "supervised": (1, "PoseNet", dict(loss_mode="min", supervised_weight=0.1)),
    "accum": (2, "PoseNet", dict(loss_mode="min", accum_steps=2)),
    "augment": (1, "PoseNet", dict(loss_mode="min", color_jitter=True, hflip=True,
                                   aug_seed=5)),
}
MULTI_STEPS = 3
# the 'augment' case at batch seed 3, where every mesh sits 2.1e-4 from
# the one-process step: each side is held to JAX's gradient instead
# (test_torch_spatial.test_augment_at_batch_seed_3_against_the_jax_gradient)
JAX_GRADIENT_CASES = {
    "augment_seed_3": (3, "PoseNet", dict(loss_mode="min", color_jitter=True, hflip=True,
                                          aug_seed=5)),
}


def _case(name):
    return STEP_CASES[name] if name in STEP_CASES else JAX_GRADIENT_CASES[name]


def step_batch(name):
    """The global batch of a STEP_CASES or JAX_GRADIENT_CASES case (uint8
    images, groundtruth)."""
    seed = _case(name)[0]
    batch = next(SyntheticTripletDataset(1, BATCH, HEIGHT, WIDTH, seed=seed,
                                         uint8_images=True).batches())
    if name == "supervised":
        batch["groundtruth"] = batch["groundtruth"].copy()
        batch["groundtruth"][2:, : HEIGHT // 2] = 0.0
    return batch


def make_state(weights, pose_name):
    """DispResNet-18 + `pose_name` with `weights` ({"depth", "PoseNet",
    "PoseFc": state dicts}), configs/tpu_v5e.yaml's Adam and a StepLR."""
    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(weights["depth"])
    pose = build_model(pose_name, device="cpu", image_shape=(HEIGHT, WIDTH))
    pose.load_state_dict(weights[pose_name])
    cfg = config_module.load_config(os.path.join(worker.REPO, "configs", "tpu_v5e.yaml"))
    optimizer = make_optimizer(cfg, depth, pose)
    return TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))


def one_step(weights, name, mesh=None):
    """The step of case `name` on its global batch, under `mesh` when
    given -> worker.step_result."""
    _, pose_name, kwargs = _case(name)
    state = make_state(weights, pose_name)
    step = make_train_step(state, device="cpu", mesh=mesh,
                           **{**worker.STEP_SETTINGS, **kwargs})
    return worker.step_result(state, step(step_batch(name)))


def multi_steps(weights, mesh=None):
    """make_multi_step over MULTI_STEPS 'min' batches (seeds 1, 2, 3) ->
    (the parameters after them, the last metrics)."""
    batches = [next(SyntheticTripletDataset(1, BATCH, HEIGHT, WIDTH, seed=seed,
                                            uint8_images=True).batches())
               for seed in range(1, MULTI_STEPS + 1)]
    state = make_state(weights, "PoseNet")
    multi = make_multi_step(state, MULTI_STEPS, mesh=mesh, device="cpu", loss_mode="min",
                            **worker.STEP_SETTINGS)
    metrics = multi({k: np.stack([b[k] for b in batches]) for k in batches[0]})
    return worker.params_of(state), {k: float(v) for k, v in metrics.items()}


def eval_step(weights, mesh=None):
    """EvalStep ('ssim' loss, Eigen protocol, pose metrics) on
    worker.eval_batch() -> (metrics, depth_pred)."""
    state = make_state(weights, "PoseNet")
    step = make_eval_step(state.depth_model, state.pose_model, loss_mode="ssim",
                          eval_protocol="eigen", pose_metrics=True, mesh=mesh, device="cpu")
    metrics, depth_pred = step(worker.eval_batch())
    return {k: float(v) for k, v in metrics.items()}, depth_pred


def digest(tensors):
    """sha256 of {name: tensor or None}'s bytes in name order: what a rank
    other than 0 returns in place of its gradients and parameters, which
    must equal rank 0's bit for bit (the results of 6 ranks would fill
    gigabytes)."""
    h = hashlib.sha256()
    for key in sorted(tensors):
        t = tensors[key]
        h.update(key.encode() + (b"none" if t is None else t.numpy().tobytes()))
    return h.hexdigest()


def steps(mesh, weights, config):
    """Every STEP_CASES step, the multi-step, the eval step and a
    Trainer.fit under the mesh; on ranks other than 0 the gradients and
    the multi-step's parameters as their digest."""
    out = {name: one_step(weights, name, mesh) for name in (*STEP_CASES,
                                                             *JAX_GRADIENT_CASES)}
    out["multi"] = multi_steps(weights, mesh)
    out["eval"] = eval_step(weights, mesh)
    out["fit"] = fit(mesh, config)
    if mesh.rank != 0:
        for name in (*STEP_CASES, *JAX_GRADIENT_CASES):
            out[name]["grads"] = digest(out[name]["grads"])
        out["multi"] = (digest(out["multi"][0]), out["multi"][1])
    return out


class StubWandb(types.ModuleType):
    """The wandb calls MetricLogger makes, recorded (tests/test_torch_visuals.py's
    stub)."""

    def __init__(self):
        super().__init__("wandb")
        self.logged = []

    def init(self, project=None, config=None):
        pass

    def Image(self, x):
        return ("image", x)

    def Histogram(self, x):
        return ("histogram", np.asarray(x).size)

    def log(self, payload, step=None):
        self.logged.append((payload, step))


def fit(mesh, config):
    """Trainer.fit under the mesh for one epoch of 2 synthetic batches
    with validation on 1, rank 0 logging to a wandb stub -> (step, last
    metrics, checkpoints written by this rank, the pictures this rank
    rendered — the arrays handed to the PNG writer —, the image names the
    stub received, and on rank 0 the pictures a Trainer without the mesh
    renders from rank 0's state and last batch)."""
    stub = StubWandb()
    sys.modules["wandb"] = stub
    config.action.mlops = True
    pictures_dir = os.path.join(config.action.checkpoint_dir, f"pictures_{mesh.rank}")
    os.makedirs(pictures_dir, exist_ok=True)
    os.chdir(pictures_dir)  # log_warps writes ./images
    rendered = []
    save = visualization.save_warp_visualization

    def record(out_dir, step, tgt, warped, depth, *args, **kwargs):
        rendered.append((tgt, warped, depth))
        return save(out_dir, step, tgt, warped, depth, *args, **kwargs)

    visualization.save_warp_visualization = record
    data = SyntheticTripletDataset(2, config.action.batch_size, *config.image_shape,
                                   seed=0, uint8_images=True)
    trainer = Trainer(config, data, log_fn=MetricLogger(config) if mesh.rank == 0 else None,
                      device="cpu", mesh=mesh)
    metrics = trainer.fit(lambda epoch: data.batches(epoch),
                          lambda: SyntheticTripletDataset(
                              1, config.action.batch_size, *config.image_shape, seed=9,
                              uint8_images=True).batches())
    one_process = None
    if mesh.rank == 0:
        plain = Trainer(config, device="cpu")
        for part in ("depth_model", "pose_model"):
            getattr(plain.state, part).load_state_dict(
                getattr(trainer.state, part).state_dict())
        one_process = plain.warp_pictures(trainer._last_batch)
    directory = trainer.checkpoints.directory
    images = [sorted(p) for p, _ in stub.logged if any(k.endswith(".png") for k in p)]
    return {"step": trainer.state.step, "metrics": metrics, "pictures": rendered,
            "one_process_pictures": one_process, "logged_images": images,
            "checkpoints": sorted(os.listdir(directory)) if os.path.isdir(directory) else []}


def layout(mesh):
    """This rank's place on the mesh and its data row's group, and the
    errors of what the mesh cannot take."""
    out = {"shape": mesh.shape, "rank": mesh.rank, "data_rank": mesh.data_rank,
           "spatial_rank": mesh.spatial_rank,
           "row_group": dist.get_process_group_ranks(mesh.spatial_group)}
    errors = {}
    try:
        make_mesh(mesh.size, spatial=3, device="cpu")
    except ValueError as e:
        errors["spatial_3"] = str(e)
    # 32 rows over spatial 2: an even split into bands of 16 rows, which
    # hold no row of the encoder's coarsest level: that level runs on the
    # gathered map (parallel/spatial.banded_level)
    batch = next(SyntheticTripletDataset(1, BATCH, 32, WIDTH, seed=1,
                                         uint8_images=True).batches())
    state = make_state(layout_weights(), "PoseNet")
    metrics = make_train_step(state, device="cpu", mesh=mesh, loss_mode="min")(batch)
    out["height_32"] = {k: float(v) for k, v in metrics.items()}
    try:
        shard_batch(mesh, {"tgt": np.zeros((BATCH, 33, WIDTH, 3), np.uint8)})
    except ValueError as e:
        errors["height_33"] = str(e)
    for name, kwargs in (("DispNetS", {}), ("StnDispNet", {"use_stn": True,
                                                           "image_shape": (64, 96)}),
                         ("DispResNet", {"all_scales": True}),
                         ("DispResNet", {"num_layers": 50, "all_scales": True}),
                         ("BtsModel", {"num_features": 128})):
        try:
            bind_spatial([build_model(name, device="cpu", **kwargs)], mesh)
        except NotImplementedError as e:
            errors[name + str(kwargs)] = str(e)
    # BtsModel binds, and whole_frames refuses a height that is no multiple
    # of 32 for it (JAX's model cannot concatenate its skips there)
    try:
        check_height(mesh, 80, WIDTH, BtsModel.row_multiple)
    except ValueError as e:
        errors["bts_height_80"] = str(e)
    out["errors"] = errors
    return out


def layout_weights():
    gen = torch.Generator().manual_seed(0)
    return {"depth": build_model("DispResNet", gen, "cpu").state_dict(),
            "PoseNet": build_model("PoseNet", gen, "cpu").state_dict()}


# --------------------------------------------------------------------------
# unit parities: each function on this rank's band of a global input
# --------------------------------------------------------------------------


def _leaf(mesh, x, dim=2):
    index = [slice(None)] * x.ndim
    index[dim] = band(mesh, x.shape[dim])
    return x[tuple(index)].clone().requires_grad_()


def _rows(mesh, x, dim=2):
    index = [slice(None)] * x.ndim
    index[dim] = band(mesh, x.shape[dim])
    return x[tuple(index)]


def layer(kind):
    """A seeded row-sharded layer of DispResNet: ("conv", k, s, p) or
    ("maxpool",) or ("conv3x3",), on 4 channels."""
    torch.manual_seed(11)
    if kind[0] == "conv":
        return layers.Conv2d(4, 5, kind[1], kind[2], kind[3], bias=False)
    if kind[0] == "maxpool":
        return layers.MaxPool2d(3, 2, 1)
    return layers.Conv3x3(4, 5)


def run_layer(kind, x, g, mesh=None, height=None):
    """-> (output, input gradient, weight gradient or None) of sum(layer(x)
    · g) on x (this rank's band under `mesh` of an image `height` rows
    tall; the layer at level 0)."""
    module = layer(kind)
    for m in module.modules():
        if isinstance(m, layers.Banded):
            m.mesh, m.level, m.height = mesh, 0, height
    leaf = x.clone().requires_grad_()
    out = module(leaf)
    (out * g).sum().backward()
    weight = next((p.grad for p in module.parameters() if p.dim() == 4), None)
    return out.detach(), leaf.grad, weight


def units(mesh, inputs):
    """Every unit of test_torch_spatial.UNITS on this rank's band."""
    out = {}
    for name, kind, x, g in inputs["layers"]:
        out[name] = run_layer(kind, _rows(mesh, x), _rows(mesh, g), mesh, x.shape[2])
    pred, target, g = inputs["ssim"]
    p, t = _leaf(mesh, pred), _leaf(mesh, target)
    m = photometric_loss(p, t, clip_loss=0.0, mesh=mesh, height=pred.shape[2])
    (m * _rows(mesh, g)).sum().backward()
    out["ssim"] = (m.detach(), p.grad, t.grad)
    out["ssim_clip"] = photometric_loss(_rows(mesh, pred), _rows(mesh, target), mesh=mesh,
                                        height=pred.shape[2])
    disp = inputs["disp"]
    d = _leaf(mesh, disp)
    value = smooth_loss([d], mesh=mesh, height=disp.shape[2])
    value.backward()
    out["smooth"] = (value.detach(), d.grad)
    d = _leaf(mesh, disp)
    normalized = normalize_depth(d, mesh)
    (normalized * _rows(mesh, inputs["g_disp"])).sum().backward()
    out["normalize_depth"] = (normalized.detach(), d.grad)
    tgt, refs, poses, intrinsics = inputs["frames"]
    disps = [_leaf(mesh, disp), _leaf(mesh, inputs["disp_ref0"])]
    pose_leaf = poses.clone().requires_grad_()
    reproj, smooth, extra = total_loss(tgt, refs, [[disps[0]], [disps[1]]], pose_leaf,
                                       intrinsics, mode="min", smooth_on="disp",
                                       smooth_weight=0.001, depth_norm=True, mesh=mesh)
    (reproj + smooth).backward()
    out["min_loss"] = ((reproj + smooth).detach(), disps[0].grad, disps[1].grad,
                       pose_leaf.grad, extra["automask_keep"])
    return out


def row_of_two(mesh, inputs, weights, config):
    """The spatial-2 mesh (world 2): the units and the steps."""
    return {"units": units(mesh, inputs), "steps": steps(mesh, weights, config)}


def two_by_two(mesh, weights, config):
    """The data 2 x spatial 2 mesh (world 4): the layout and the steps."""
    return {"layout": layout(mesh), "steps": steps(mesh, weights, config)}

