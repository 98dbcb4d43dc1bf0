"""Ranks of tests/test_torch_spatial_zoo.py: gloo process groups on the CPU
under a ("data", "spatial") mesh, spawned by
tests/torch_parallel_worker.start_ranks(..., spatial=s), that run
DispNetS, StnDispNet and DispResNet on bands — bands that hold no row of
a net's coarser levels among them — and the banded units they are built
of.

Kept out of the test module (and out of pytest's collection, by its
name) so that a spawned rank imports torch and the port only, not JAX.
"""

import os

import torch

from tests import torch_parallel_worker as worker
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.models import layers
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel import spatial
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    bind_batch_norm,
    bind_spatial,
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

BATCH = 2
# name -> (depth net, its kwargs, the weights it loads, height, width,
# spatial, batch seed). 64 rows over 2 are bands of 32 (DispNetS's 64x
# and 128x levels gathered), 64 over 4 JAX's equal bands of 16
# (DispResNet's 32x level gathered), 104 over 4 the bands 32 / 32 / 32 / 8
# (1 row at scale 3: the smoothness halo ends at the image's border). The
# batch seeds of DispNetS and StnDispNet are tests/test_torch_zoo_train's
# (its docstring: their steps are chaotic at most seeds)
CASES = {
    "dispnets": ("DispNetS", {}, "dispnets", 64, 96, 2, 3),
    "stn": ("StnDispNet", {"use_stn": True, "image_shape": (64, 96)}, "stn", 64, 96, 2, 4),
    "resnet_h64": ("DispResNet", {}, "depth", 64, 64, 4, 1),
    "resnet_h104_all_scales": ("DispResNet", {"all_scales": True}, "depth", 104, 48, 4, 1),
}
# the pose weights of a case: DispNetS' and StnDispNet's with the smaller
# head bias of tests/test_torch_zoo_train (their depths are nearer)
POSE_KEY = {"dispnets": "pose_near", "stn": "pose_near"}
# the forward units: (net, kwargs, weights, height, width), on bands of
# the units' groups (2 ranks: 32 / 32; 4 ranks: 16 each)
FORWARDS = {
    "dispnets": ("DispNetS", {}, "dispnets", 64, 96),
    "stn": ("StnDispNet", {"use_stn": True, "image_shape": (64, 96)}, "stn", 64, 96),
    "stn_off": ("StnDispNet", {"image_shape": (64, 96)}, "stn_off", 64, 96),
    "resnet": ("DispResNet", {}, "depth", 64, 64),
}
# the transposed-conv units: (image height, the input's level): its bands
# 32 / 32 (level 1 of 128 rows), 64 / 32 (level 0 of 96 rows) and 32 / 3
# (level 1 of 70 rows: an odd last band)
TRANSPOSED = ((128, 1), (96, 0), (70, 1))
# the halo unit: every band's rows (a band of one row between others)
HALO_ROWS = (3, 1, 1, 2)
HALO_REACH = (2, 3)


def step_batch(name):
    """Case `name`'s global batch (uint8 images)."""
    height, width, _, seed = CASES[name][3:]
    return next(SyntheticTripletDataset(1, BATCH, height, width, seed=seed,
                                        uint8_images=True).batches())


def make_state(weights, name):
    """Case `name`'s depth net and PoseNet with `weights`, configs/
    tpu_v5e.yaml's Adam and a StepLR."""
    net, kwargs, key = CASES[name][:3]
    depth = build_model(net, device="cpu", **kwargs)
    depth.load_state_dict(weights[key])
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(weights[POSE_KEY.get(name, "pose")])
    cfg = config_module.load_config(os.path.join(worker.REPO, "configs", "tpu_v5e.yaml"))
    optimizer = make_optimizer(cfg, depth, pose)
    return TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))


def one_step(weights, name, mesh=None):
    """Case `name`'s step ('min', worker.STEP_SETTINGS) on its global
    batch, under `mesh` when given -> worker.step_result."""
    state = make_state(weights, name)
    step = make_train_step(state, device="cpu", mesh=mesh, loss_mode="min",
                           **worker.STEP_SETTINGS)
    return worker.step_result(state, step(step_batch(name)))


def steps(mesh, weights, names):
    """The steps of `names` under the mesh; on ranks other than 0 the
    gradients as their digest (tests/torch_spatial_worker.digest)."""
    from tests.torch_spatial_worker import digest

    out = {name: one_step(weights, name, mesh) for name in names}
    if mesh.rank != 0:
        for result in out.values():
            result["grads"] = digest(result["grads"])
    return out


def eval_metrics(weights, name, mesh=None):
    """The eval step's metrics ('min' loss, Eigen depth metrics on the
    gathered depth, pose metrics) on case `name`'s batch, under `mesh`
    when given."""
    state = make_state(weights, name)
    step = make_eval_step(state.depth_model, state.pose_model, loss_mode="min",
                          eval_protocol="eigen", pose_metrics=True, mesh=mesh, device="cpu")
    metrics, depth = step(step_batch(name))
    return {k: float(v) for k, v in metrics.items()}, depth


def one_rank(mesh, weights, inputs, names):
    """Under a data-only mesh of one rank — the whole image, with the
    BatchNorm of layers._GlobalBatchNorm that the bands use — every
    forward unit in train mode and the steps of `names`."""
    return {"forward": {name: forward(mesh, weights, name, inputs, True)
                        for name in FORWARDS},
            "steps": {name: one_step(weights, name, mesh) for name in names}}


def _rows(mesh, x, height, level=0, dim=2):
    """This rank's rows of a whole map x (all of them without a mesh)."""
    if mesh is None:
        return x
    index = [slice(None)] * x.ndim
    index[dim] = spatial.band(mesh, height, level)
    return x[tuple(index)]


def forward(mesh, weights, name, inputs, train, dtype=torch.float32):
    """FORWARDS[name] on this rank's band of inputs' image (the whole
    image without a mesh), in train or eval mode, the model and its
    inputs in `dtype` -> (each output — a band of each scale: every scale
    of these cases is banded —, the parameter gradients of Σ output ·
    cotangent in train mode, and under a spatial mesh the outputs'
    declared placement, torch_parallel_worker.placement)."""
    net, kwargs, key, height, _ = FORWARDS[name]
    x, cotangents = inputs[name]
    model = build_model(net, device="cpu", **kwargs)
    model.load_state_dict(weights[key])
    model.to(dtype)
    bind_spatial([model], mesh)
    bind_batch_norm([model], mesh)
    model.train(train)
    if spatial.row_sharded(mesh):
        outs = model(_rows(mesh, x.to(dtype), height), height=height)
    else:
        outs = model(x.to(dtype))
    placed = worker.placement(mesh, model, outs, height)
    if not train:
        return [o.detach() for o in outs], None, placed
    total = 0.0
    for scale, (o, g) in enumerate(zip(outs, cotangents)):
        total = total + (o * _rows(mesh, g.to(dtype), height, scale)).sum()
    total.backward()
    return ([o.detach() for o in outs],
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None},
            placed)


def transposed(mesh, inputs):
    """layers.ConvTranspose2d on this rank's band of each TRANSPOSED input
    -> (output, d input, d weight, d bias) of Σ output · cotangent."""
    out = []
    for (height, level), (x, g, state) in zip(TRANSPOSED, inputs["transposed"]):
        layer = layers.conv_transpose(x.shape[1], g.shape[1], level)
        layer.load_state_dict(state)
        layer.mesh = mesh if spatial.row_sharded(mesh) else None
        layer.height = height
        leaf = _rows(mesh, x, height, level).clone().requires_grad_()
        y = layer(leaf)
        rows = spatial.band(mesh, height, level)  # the output: 2x its rows
        (y * g[:, :, 2 * rows.start:2 * rows.stop]).sum().backward()
        out.append((y.detach(), leaf.grad, layer.weight.grad, layer.bias.grad))
    return out


def group_norm(mesh, inputs):
    """layers.GroupNorm on this rank's band (of a 96-row image: 64 / 32)
    -> (output, d input, d weight, d bias) of Σ output · cotangent."""
    x, g, state = inputs["group_norm"]
    layer = layers.group_norm(x.shape[1], 0)
    layer.load_state_dict(state)
    layer.mesh = mesh if spatial.row_sharded(mesh) else None
    layer.height = x.shape[2]
    leaf = _rows(mesh, x, x.shape[2]).clone().requires_grad_()
    y = layer(leaf)
    (y * _rows(mesh, g, x.shape[2])).sum().backward()
    return y.detach(), leaf.grad, layer.weight.grad, layer.bias.grad


def halo_unit(mesh, inputs):
    """spatial.halo of HALO_REACH rows around this rank's band of a map
    whose bands hold HALO_ROWS rows -> (output, d input) of Σ output ·
    this rank's cotangent."""
    x, cotangents = inputs["halo"]
    start = sum(HALO_ROWS[:mesh.spatial_rank])
    leaf = x[:, :, start:start + HALO_ROWS[mesh.spatial_rank]].clone().requires_grad_()
    y = spatial.halo(leaf, mesh, *HALO_REACH, HALO_ROWS)
    (y * cotangents[mesh.spatial_rank]).sum().backward()
    return y.detach(), leaf.grad


def gathered_batch_norm(mesh, inputs):
    """A band (of a 64-row map: 32 / 32) gathered with its gradient, a
    train-mode layers.BatchNorm2d on the whole map (under the mesh: its
    global statistics sum every rank's copy), this rank's band cut back
    out -> (d band, running mean, running var, d weight, d bias) of
    Σ band · cotangent."""
    x, g, state = inputs["batch_norm"]
    bn = layers.BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1)
    bn.load_state_dict(state)
    bn.mesh = mesh
    bn.train()
    height = x.shape[2]
    leaf = _rows(mesh, x, height).clone().requires_grad_()
    whole = leaf if mesh is None else spatial.gather_band(leaf, mesh, height)
    y = bn(whole)
    if mesh is not None:
        y = spatial.cut_band(y, mesh, height)
    (y * _rows(mesh, g, height)).sum().backward()
    return (leaf.grad, bn.running_mean.clone(), bn.running_var.clone(), bn.weight.grad,
            bn.bias.grad)


def units(mesh, weights, inputs, forwards):
    """The unit results of this group: the forwards of `forwards` in both
    modes, and with 2 ranks the transposed conv, GroupNorm and gathered
    BatchNorm units, with 4 the halo unit."""
    out = {"forward": {(name, train): forward(mesh, weights, name, inputs, train)
                       for name in forwards for train in (False, True)}}
    if mesh.spatial == 2:
        out.update(transposed=transposed(mesh, inputs), group_norm=group_norm(mesh, inputs),
                   batch_norm=gathered_batch_norm(mesh, inputs))
    else:
        out["halo"] = halo_unit(mesh, inputs)
    return out


def ranks(mesh, weights, inputs, forwards, names):
    """One group's units, eval steps and train steps."""
    return {"units": units(mesh, weights, inputs, forwards),
            "eval": {name: eval_metrics(weights, name, mesh) for name in names},
            "steps": steps(mesh, weights, names)}
