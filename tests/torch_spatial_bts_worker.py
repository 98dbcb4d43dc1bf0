"""Ranks of tests/test_torch_spatial_bts.py: gloo process groups on the CPU
under a ("data", "spatial") mesh, spawned by
tests/torch_parallel_worker.start_ranks(..., spatial=s), that train
BtsModel on bands, run the banded units it adds (the dilated Conv2d, the
2x2 AvgPool2d) and the non-integer resamples of a band (a coarse map
resized whole and cut back), and train the nets whose coarse maps take
them (DispResNet-18 with all_scales and DispNetS at a height that is no
multiple of 8, StnDispNet at one that is no multiple of 16).

Kept out of the test module (and out of pytest's collection, by its
name) so that a spawned rank imports torch and the port only, not JAX.
"""

import copy
import os

import torch

from tests import torch_parallel_worker as worker
from tests.torch_spatial_worker import digest
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.losses import reprojection
from unsupervised_pseuso_lidar_tpu_torch.models import layers
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel import spatial
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    bind_spatial,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

BATCH = 2
# the narrowest BtsModel whose decoder is JAX's (tests/test_torch_bts.py:
# below 128 the final Reduction1x1 builds no layer); DenseNet-161 itself
# cannot be narrowed
NUM_FEATURES = 128
# name -> (depth net, its kwargs, height, width, batch seed, steps). BTS at
# 64 rows: over 2 ranks bands of 32 (every level banded; the ASPP's 24-row
# halos at 1/8 reach past the 4-row band), over 4 JAX's equal bands of 16
# (the 1/32 level gathered, one row a band at 1/16). The non-integer
# resamples: 100 rows over 2 are bands of 64 / 36, whose coarse maps of
# 13 (1/8) rows upsample to 100; StnDispNet's decoder returns 80 rows of
# a 72-row image (bands 64 / 8). StnDispNet runs without its STN: at the
# STN's identity start every sample of its grid_sample lies on a pixel,
# where the bilinear gradient jumps, so its step's gradient moves by
# 1e-2 – 1e-1 under 1e-7 relative noise on the weights at every batch
# seed tried (1 – 8); without it, by ~1e-5 at seed 8 (on a CPU)
CASES = {
    "bts": ("BtsModel", {"num_features": NUM_FEATURES}, 64, 96, 3, 2),
    "all_scales_h100": ("DispResNet", {"all_scales": True}, 100, 48, 1, 1),
    "dispnets_h100": ("DispNetS", {}, 100, 48, 3, 1),
    "stn_h72": ("StnDispNet", {"image_shape": (72, 48)}, 72, 48, 8, 1),
}
# the groups: spatial size -> the cases its ranks train
GROUPS = {2: ("bts", "all_scales_h100", "dispnets_h100", "stn_h72"), 4: ("bts",)}
# the dilated-conv units: (dilation, image height) on level 0 over 4
# ranks — JAX's equal bands of 10 rows (40 over 4) and 16 (64 over 4)
DILATED = ((3, 40), (24, 40), (24, 64))
# the average-pool units: (image height, the input's level) over 4 ranks:
# 40 rows' level 0 (bands of 10 -> 5) and level 1 (its output level 2 is
# not banded: the pool runs on the gathered map)
POOLED = ((40, 0), (40, 1), (64, 0))
# the resize units over 2 ranks: (image height, scale): 100 rows (bands
# 64 / 36) at scales 1-3, 72 rows (64 / 8) at scale 3
RESIZED = ((100, 1), (100, 2), (100, 3), (72, 3))
# the STN unit over 2 ranks: StnDispNet with its STN on images of this
# (height, width), bands 64 / 8: its 32x map and its frame are gathered,
# and its 80-row output is gathered whole from the bands
STN_SHAPE = (72, 48)


def weights():
    """{net: state dict} of every case's depth net and PoseNet, seeded;
    PoseNet's head bias moves the warp by a few pixels (at the identity
    warp every sample lies on a pixel, where the bilinear gradient
    jumps)."""
    gen = torch.Generator().manual_seed(13)
    out = {name: build_model(net, gen, "cpu", **kwargs).state_dict()
           for name, (net, kwargs, *_) in CASES.items()}
    pose = build_model("PoseNet", gen, "cpu").state_dict()
    bias = torch.randn(12, generator=gen) * torch.tensor([0.005] * 3 + [0.03] * 3).repeat(2)
    pose["pose_pred.bias"] = bias / 0.06
    out["pose"] = pose
    return out


def step_batches(name):
    """Case `name`'s global batches (uint8 images), one a step."""
    height, width, seed, steps = CASES[name][2:]
    return list(SyntheticTripletDataset(steps, BATCH, height, width, seed=seed,
                                        uint8_images=True).batches())


def make_state(weights, name):
    """Case `name`'s depth net and PoseNet with `weights`, configs/
    tpu_v5e.yaml's Adam and a StepLR."""
    net, kwargs = CASES[name][:2]
    depth = build_model(net, device="cpu", **kwargs)
    depth.load_state_dict(weights[name])
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(weights["pose"])
    cfg = config_module.load_config(os.path.join(worker.REPO, "configs", "tpu_v5e.yaml"))
    optimizer = make_optimizer(cfg, depth, pose)
    return TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))


PARTS = ("depth_model", "pose_model", "optimizer")


def train(weights, name, mesh=None, starts=None):
    """Case `name`'s steps ('min', worker.STEP_SETTINGS) on its global
    batches, under `mesh` when given -> [worker.step_result of each]; on
    ranks other than 0 the gradients as their digest. Each step starts
    from the state in `starts` (the one-process step's: a step's gradient
    jumps where a sample crosses a pixel, and Adam's first update moves
    every parameter by ±lr whatever its gradient's size, so two runs that
    part by one ulp at step 1 part by ~1e-2 at step 2); without them the
    steps follow each other and each result holds the state it started
    from ("start"). Each result holds its step's first depth forward's
    declared placement ("placement", torch_parallel_worker.placement)."""
    state = make_state(weights, name)
    step = make_train_step(state, device="cpu", mesh=mesh, loss_mode="min",
                           **worker.STEP_SETTINGS)
    placed = []
    state.depth_model.register_forward_hook(
        lambda net, args, kwargs, outs: placed.append(
            worker.placement(mesh, net, outs, kwargs.get("height"))), with_kwargs=True)
    out = []
    for i, batch in enumerate(step_batches(name)):
        if starts is not None:
            for part in PARTS:
                getattr(state, part).load_state_dict(starts[i][part])
        else:
            start = {part: copy.deepcopy(getattr(state, part).state_dict()) for part in PARTS}
        placed.clear()
        result = worker.step_result(state, step(batch))
        result["placement"] = placed[0]
        if mesh is not None and mesh.rank != 0:
            result["grads"] = digest(result["grads"])
        if starts is None:
            result["start"] = start
        out.append(result)
    return out


def one_rank(mesh, weights, starts):
    """Every case's steps under a data-only mesh of one rank from `starts`
    ({case: its steps' start states}): the whole image, with the
    BatchNorm of layers._GlobalBatchNorm that the bands use."""
    return {name: train(weights, name, mesh, starts[name]) for name in CASES}


def _rows(mesh, x, height, level=0):
    """This rank's rows of a whole map x (all of them without a mesh)."""
    return x if mesh is None else x[:, :, spatial.band(mesh, height, level)]


def _bind(layer, mesh, height):
    layer.mesh = mesh if spatial.row_sharded(mesh) else None
    layer.height = height
    return layer


def dilated(mesh, inputs):
    """layers.conv(dilation=d) (3x3, padding d) on this rank's band of each
    DILATED input -> (output, d input, d weight) of Σ output · cotangent."""
    out = []
    for (d, height), (x, g, state) in zip(DILATED, inputs["dilated"]):
        layer = _bind(layers.conv(x.shape[1], g.shape[1], 3, bias=False, level=0,
                                  dilation=d), mesh, height)
        layer.load_state_dict(state)
        leaf = _rows(mesh, x, height).clone().requires_grad_()
        y = layer(leaf)
        (y * _rows(mesh, g, height)).sum().backward()
        out.append((y.detach(), leaf.grad, layer.weight.grad))
    return out


def pooled(mesh, inputs):
    """layers.avg_pool on this rank's band of each POOLED input -> (output:
    its band, or the whole map where its output level is not banded; d
    input) of Σ output · cotangent (1/spatial of it on a whole map)."""
    out = []
    for (height, level), (x, g) in zip(POOLED, inputs["pooled"]):
        layer = _bind(layers.avg_pool(level), mesh, height)
        leaf = _rows(mesh, x, height, level).clone().requires_grad_()
        y = layer(leaf)
        if spatial.on_bands(mesh, height, level + 1):
            g = _rows(mesh, g, height, level + 1)
        elif spatial.row_sharded(mesh):
            # every rank's copy of the whole output: the ranks' cotangents add
            g = g / mesh.spatial
        (y * g).sum().backward()
        out.append((y.detach(), leaf.grad))
    return out


def resized(mesh, inputs):
    """The loss's full-resolution depth (reprojection._full_res_depth) of
    this rank's band of each RESIZED coarse map -> (this rank's rows of
    the image, d band) of Σ rows · cotangent."""
    out = []
    for (height, scale), (x, g) in zip(RESIZED, inputs["resized"]):
        leaf = _rows(mesh, x, height, scale).clone().requires_grad_()
        y = reprojection._full_res_depth(leaf, height, g.shape[-1], mesh, scale)
        (y * _rows(mesh, g[:, None], height)[:, 0]).sum().backward()
        out.append((y.detach(), leaf.grad))
    return out


def stn(mesh, inputs):
    """StnDispNet with its STN and inputs["stn"]'s weights on this rank's
    band of its images (the whole without a mesh) -> (its output, every
    rank's copy of the whole map; d band; its declared placement,
    torch_parallel_worker.placement) of Σ output · cotangent (1/spatial of
    it on each rank's copy: the gather's backward adds them)."""
    x, g, state = inputs["stn"]
    net = build_model("StnDispNet", device="cpu", use_stn=True, image_shape=STN_SHAPE)
    net.load_state_dict(state)
    if mesh is not None:
        bind_spatial([net], mesh)
        g = g / mesh.spatial
    leaf = _rows(mesh, x, STN_SHAPE[0]).clone().requires_grad_()
    outs = net(leaf, STN_SHAPE[0])
    y = outs[0]
    (y * g).sum().backward()
    return y.detach(), leaf.grad, worker.placement(mesh, net, outs, STN_SHAPE[0])


def ranks(mesh, weights, inputs, names, starts):
    """One group's units (the dilated convs and pools over 4 ranks, the
    resizes and the STN over 2) and the steps of `names` from `starts`."""
    units = ({"dilated": dilated(mesh, inputs), "pooled": pooled(mesh, inputs)}
             if mesh.spatial == 4 else {"resized": resized(mesh, inputs),
                                        "stn": stn(mesh, inputs)})
    return {"units": units,
            "steps": {name: train(weights, name, mesh, starts[name]) for name in names}}
