"""Training runtime: state, train step, validation step, epoch loop.

Counterpart of unsupervised_pseuso_lidar_tpu/train/trainer.py
(make_lr_schedule :58, make_optimizer :66, create_train_state :99,
forward_batch :164, normalize_uint8_batch :213, make_train_step_body
:231-401, make_eval_step :480, Trainer :561, _warn_if_collapsed :683,
log_warps :742, fit :783, make_multi_step :447). On a CUDA device without
a mesh or under an NCCL mesh the train step, its K-step form and the eval
step run as CUDA graphs (train/graph.py), the counterpart of JAX's jitted
steps (_jit_with_mesh :404-416 jits them under the mesh too); `graph=`
of the step constructors and of Trainer turns that off (False) or
insists on it (True). Under a mesh
(parallel/mesh.py; `mesh=` of TrainStep, EvalStep, make_multi_step and
Trainer) each rank runs the step on its block of the global batch and the
result is the JAX step's on the global batch: BatchNorm statistics, the
'ssim' clip threshold and the supervised masked mean are all-reduced
where they are taken, the parameter gradients are averaged once a step
before the optimizer, and the metrics are global means on every rank.
With a "spatial" axis a rank's block is a band of its images' rows:
the depth net (DispResNet, DispNetS, StnDispNet or BtsModel) runs on the band with
halo-exchanging layers (bind_spatial), the pose net on the whole frames,
which the step gathers from the bands of its data row, and the loss on
the band (losses/total.py).

Batches use the JAX package's schema and layout — tgt [B, H, W, 3],
ref_imgs [B, 2, H, W, 3] (uint8 or ImageNet-normalized float),
intrinsics [B, 3, 3], optionally oxts [B, 2, 6] and groundtruth
[B, H, W] — as numpy arrays or tensors; `batch_to_device` moves them to
the device as NCHW tensors.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import os
import signal
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from unsupervised_pseuso_lidar_tpu_torch.data.augment import (
    AugmentParams,
    augment_batch,
    draw_params,
)
from unsupervised_pseuso_lidar_tpu_torch.eval.metrics import (
    METRICS,
    compute_errors,
    eigen_crop_mask,
)
from unsupervised_pseuso_lidar_tpu_torch.eval.pose import pose_errors
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import disp_to_depth, inverse_warp
from unsupervised_pseuso_lidar_tpu_torch.losses.total import total_loss
from unsupervised_pseuso_lidar_tpu_torch.models.depth.bts import BtsModel
from unsupervised_pseuso_lidar_tpu_torch.models.depth.dispnet import DispNetS
from unsupervised_pseuso_lidar_tpu_torch.models.depth.resnet_dispnet import DispResNet
from unsupervised_pseuso_lidar_tpu_torch.models.depth.stn_dispnet import StnDispNet
from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    Banded,
    BatchNorm2d,
    frozen_running_statistics,
)
from unsupervised_pseuso_lidar_tpu_torch.models.pose.pose_fc import PoseFc
from unsupervised_pseuso_lidar_tpu_torch.models.pose.posenet import PoseNet
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import (
    Mesh,
    shard_batch,
    shard_train_state,
)
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import (
    band,
    check_height,
    gather_rows,
    is_band,
    row_sharded,
)
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_pretrained_depth,
    load_pretrained_pose,
    place_optimizer,
)
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.train.graph import StepGraphs, graph_enabled
from unsupervised_pseuso_lidar_tpu_torch.utils.device import constant, resolve_device
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import abs_
from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import (
    SavedBytes,
    annotate,
    set_counter,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)


def batch_to_device(
    batch: Dict, device: torch.device, keep_groundtruth: bool = False
) -> Dict[str, torch.Tensor]:
    """{tgt [B,H,W,3], ref_imgs [B,2,H,W,3], intrinsics[, oxts]} (numpy or
    tensors) -> tensors on `device`: tgt [B,3,H,W], ref_imgs [B,2,3,H,W],
    intrinsics and oxts fp32. uint8 images stay uint8 (a quarter of the
    fp32 bytes to copy). keep_groundtruth also moves groundtruth [B, H, W]
    (fp32) when present."""
    def to(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)

    tgt = to(batch["tgt"]).to(device, non_blocking=True)
    refs = to(batch["ref_imgs"]).to(device, non_blocking=True)
    out = {
        "tgt": tgt.permute(0, 3, 1, 2).contiguous(),
        "ref_imgs": refs.permute(0, 1, 4, 2, 3).contiguous(),
        "intrinsics": to(batch["intrinsics"]).to(device, torch.float32, non_blocking=True),
    }
    if "oxts" in batch:
        out["oxts"] = to(batch["oxts"]).to(device, torch.float32, non_blocking=True)
    if keep_groundtruth and "groundtruth" in batch:
        out["groundtruth"] = to(batch["groundtruth"]).to(device, torch.float32,
                                                         non_blocking=True)
    return out


def whole_frames(mesh: Optional[Mesh], batch: Dict[str, torch.Tensor],
                 depth_model: Optional[nn.Module] = None,
                 height: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Under a mesh with a "spatial" axis: a device batch whose tgt and
    ref_imgs hold this rank's band of the rows of images `height` rows
    tall (a host value: the global batch's, sharded_height) -> the same
    batch with the whole frames, gathered from the bands of the data row
    (the warp's sources and the pose net's input;
    parallel/spatial.gather_rows, in the batch's dtype). Raises
    ValueError, on every rank, for a height `depth_model` cannot shard
    (check_height with its row_multiple: BtsModel's 32). The batch itself
    otherwise."""
    if not row_sharded(mesh):
        return batch
    tgt = batch["tgt"]
    if height is None:
        raise ValueError("whole_frames under a spatial mesh needs the image height")
    check_height(mesh, height, tgt.shape[3], getattr(depth_model, "row_multiple", 1))
    return dict(batch, tgt=gather_rows(tgt, mesh, 2, height),
                ref_imgs=gather_rows(batch["ref_imgs"], mesh, 3, height))


def sharded_height(mesh: Optional[Mesh], batch: Dict) -> Optional[int]:
    """The global image height of a batch that shard_batch placed (a
    ShardedBatch) under a mesh with a "spatial" axis, where a rank holds a
    band of the rows: the host's value, so that the step's body reads no
    device value to learn it. None otherwise (nothing needs it; a plain
    dict under a spatial axis then fails in whole_frames)."""
    return getattr(batch, "height", None) if row_sharded(mesh) else None


def depth_scales(model: Optional[nn.Module]) -> Tuple[int, ...]:
    """The scale of each output of a depth net (its map 2**scale times
    smaller than the image): its `scales` (DispResNet's one or four,
    DispNetS's four, BtsModel's five full-resolution maps), (0,) for a
    net that does not say (StnDispNet)."""
    return tuple(getattr(model, "scales", (0,)))


def whole_rows(x: torch.Tensor, mesh: Optional[Mesh], height: int) -> torch.Tensor:
    """A full-resolution map [B, R, W] of a depth net's output -> the
    whole map: gathered from the bands where it is this rank's band
    (gather_rows, no gradient), itself where the net returned it whole
    (StnDispNet's 16·ceil(H/16) rows)."""
    return gather_rows(x, mesh, 1, height) if is_band(x, mesh, height, 0, 1) else x


def normalize_uint8_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 NCHW image batch -> ImageNet-normalized float32 (float input
    passes through unchanged)."""
    if batch["tgt"].dtype != torch.uint8:
        return batch
    device = batch["tgt"].device
    mean = constant(tuple(IMAGENET_MEAN.tolist()), torch.float32, device)[:, None, None]
    std = constant(tuple(IMAGENET_STD.tolist()), torch.float32, device)[:, None, None]

    def norm(x):
        return (x.float() / 255.0 - mean) / std

    return dict(batch, tgt=norm(batch["tgt"]), ref_imgs=norm(batch["ref_imgs"]))


def forward_batch(
    depth_model: nn.Module,
    pose_model: nn.Module,
    batch: Dict[str, torch.Tensor],
    train: bool = False,
    semi_sup_pose: bool = False,
    rows: slice = slice(None),
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Depth (tgt and ref0 stacked into one 2B pass, so train-mode
    BatchNorm statistics come from the joint batch, as in JAX) and pose
    forward on a normalized NCHW batch, the models in train or eval mode
    -> (disps_tgt, disps_ref0, poses). With semi_sup_pose the poses are
    the batch's OXTS odometry [B, 2, 6] and the pose net does not run (so
    it gets no gradient). The depth net sees the image `rows` (a rank's
    band under a spatial mesh, with the image's height), the pose net the
    whole frames."""
    depth_model.train(train)
    pose_model.train(train)
    tgt = batch["tgt"]
    ref0 = batch["ref_imgs"][:, 0]
    ref1 = batch["ref_imgs"][:, 1]
    bsz = tgt.shape[0]
    images = torch.cat([tgt, ref0], dim=0)
    if isinstance(depth_model, Banded) and row_sharded(depth_model.mesh):
        disps = depth_model(images[:, :, rows], height=images.shape[2])
    else:
        disps = depth_model(images[:, :, rows])
    disps_tgt = [d[:bsz] for d in disps]
    disps_ref0 = [d[bsz:] for d in disps]
    if semi_sup_pose:
        poses = batch["oxts"]
    else:
        poses = pose_model(tgt, [ref0, ref1])
    return disps_tgt, disps_ref0, poses


def _check_precision(precision: str) -> None:
    if precision not in ("fp32", "bf16"):
        raise ValueError("precision must be 'fp32' or 'bf16'")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


@dataclass
class TrainState:
    """Models, optimizer, scheduler and the optimizer-step count — the
    port's counterpart of the JAX TrainState (params, batch_stats and
    opt_state live in the modules and the optimizer)."""

    depth_model: nn.Module
    pose_model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def make_lr_schedule(
    optimizer: torch.optim.Optimizer,
    step_size_epochs: int,
    gamma: float,
    steps_per_epoch: int,
) -> torch.optim.lr_scheduler.StepLR:
    """torch StepLR semantics, stepped once per optimizer step: lr ·
    gamma^(step // (step_size_epochs · steps_per_epoch))."""
    boundary = max(1, step_size_epochs * steps_per_epoch)
    return torch.optim.lr_scheduler.StepLR(optimizer, step_size=boundary, gamma=gamma)


def make_optimizer(
    config: Config, depth_model: nn.Module, pose_model: nn.Module
) -> torch.optim.Adam:
    """Adam (β 0.9/0.999, eps 1e-8: optax.adam's defaults) over both nets;
    one param group per net when depth_lr != pose_lr. Capturable on a
    CUDA device (checkpoint.place_optimizer), as a CUDA graph of the step
    needs."""
    opt = config.action.optimizer
    depth_params = list(depth_model.parameters())
    pose_params = list(pose_model.parameters())
    if opt.depth_lr == opt.pose_lr:
        groups = [{"params": depth_params + pose_params, "lr": opt.depth_lr}]
    else:
        groups = [{"params": depth_params, "lr": opt.depth_lr},
                  {"params": pose_params, "lr": opt.pose_lr}]
    optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    place_optimizer(optimizer)
    return optimizer


@contextlib.contextmanager
def learning_rates(optimizer: torch.optim.Optimizer, lr: torch.Tensor):
    """Within: each param group's lr is its entry of `lr` [groups], a
    tensor that a CUDA graph of optimizer.step() reads at each replay. The
    groups keep their floats outside, which the scheduler steps on the
    host; the train step writes them into the tensor for each step."""
    floats = [group["lr"] for group in optimizer.param_groups]
    for group, value in zip(optimizer.param_groups, lr.unbind()):
        group["lr"] = value
    try:
        yield
    finally:
        for group, value in zip(optimizer.param_groups, floats):
            group["lr"] = value


def create_train_state(
    config: Config,
    generator: torch.Generator,
    steps_per_epoch: int = 1000,
    device: str | torch.device = "cuda",
) -> TrainState:
    """Models (weights drawn from `generator`, then a head's
    pretrained_path loaded over them when set), optimizer and schedule on
    `device`."""
    device = resolve_device(device)
    depth, pose = config.model.depth, config.model.pose
    depth_model = build_model(depth.name, generator, device,
                              image_shape=config.image_shape, **depth.kwargs)
    pose_model = build_model(pose.name, generator, device,
                             image_shape=config.image_shape, **pose.kwargs)
    # the step calls pose_model(tgt, [ref0, ref1]); JAX's init makes that
    # call and raises TypeError for a pose net of another signature
    # (PoseDecoder takes encoder features)
    inspect.signature(pose_model.forward).bind(None, [None, None])
    if depth.pretrained_path:
        # the reference's model of record starts from an ImageNet encoder
        load_pretrained_depth(depth_model, depth.pretrained_path)
    if pose.pretrained_path:
        load_pretrained_pose(pose_model, pose.pretrained_path)
    optimizer = make_optimizer(config, depth_model, pose_model)
    sched = config.action.scheduler
    scheduler = make_lr_schedule(optimizer, sched.step_size, sched.gamma,
                                 steps_per_epoch)
    return TrainState(depth_model, pose_model, optimizer, scheduler)


def automask_ident_scale(step: int, warmup: int) -> float:
    """The automask warm-up's scale of the identity term at `step`: from
    1e4 (unreachable) down to 1 (exact) over `warmup` steps, 10 ** (4 (1 −
    clip(step / warmup, 0, 1))) with JAX's fp32 bits: XLA divides by the
    constant as a multiply by its fp32 reciprocal, and a 0-dim fp32
    torch.pow takes the scalar power XLA's CPU power gives (torch's
    vectorized pow does not). Host arithmetic: the same value on every
    device."""
    ramp = torch.tensor(step, dtype=torch.float32) * torch.reciprocal(
        torch.tensor(warmup, dtype=torch.float32))
    exponent = 4.0 * (1.0 - torch.clamp(ramp, 0.0, 1.0))
    return float(torch.pow(torch.tensor(10.0), exponent))


def supervised_loss(disp: torch.Tensor, groundtruth: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sparse-LiDAR term: masked L1 in meters between the finest-scale
    depth of `disp` [B, 1, H, W] and `groundtruth` [B, H, W] (0 = no
    LiDAR return), with jnp.abs' gradient rule at a tie. Under a data
    mesh the masked sum (differentiably) and the valid count are
    all-reduced before the division: the global batch's mean, since the
    ranks hold different numbers of LiDAR returns."""
    pred = disp_to_depth(disp[:, 0])
    valid = (groundtruth > 1e-3).float()
    total = torch.sum(abs_(pred - groundtruth) * valid)
    count = valid.sum()
    if mesh is not None:
        total = mesh.all_reduce_sum(total)
        count = mesh.all_reduce_(count)
    return total / torch.clamp(count, min=1.0)


def bind_batch_norm(models, mesh: Optional[Mesh]) -> None:
    """Point every BatchNorm2d of `models` at `mesh`: training statistics
    over the global batch under a distributed mesh (models/layers.py)."""
    for model in models:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.mesh = mesh


# the nets that run under a spatial mesh: the depth nets on bands, the
# pose nets on the whole frames (their 7 stride-2 convs leave fewer rows
# than ranks)
SPATIAL_NETS = (DispResNet, DispNetS, StnDispNet, BtsModel, PoseNet, PoseFc)


def bind_spatial(models, mesh: Optional[Mesh]) -> None:
    """Point the row-sharded modules of `models` (layers.Banded: the
    depth nets and their convs, transposed convs, max-pools and
    GroupNorms) at `mesh` when it has a "spatial" axis — they then run on
    bands, exchanging halos with the neighbouring bands or gathering the
    levels whose bands hold no whole row — and unbind them otherwise.

    Under a spatial mesh the depth net must be DispResNet (any depth, one
    output scale or all_scales), DispNetS, StnDispNet (with or without
    its STN) or BtsModel, and the pose net PoseNet or PoseFc; any other
    model (PoseDecoder, which the step cannot call) raises
    NotImplementedError, naming it."""
    sharded = row_sharded(mesh)
    for model in models:
        if sharded and not isinstance(model, SPATIAL_NETS):
            raise NotImplementedError(
                f"{type(model).__name__} under a spatial mesh: the step takes DispResNet, "
                "DispNetS, StnDispNet or BtsModel with PoseNet or PoseFc")
        for m in model.modules():
            if isinstance(m, Banded):
                m.mesh = mesh if sharded else None


def all_reduce_gradients(mesh: Mesh, params) -> None:
    """Average the gradients of `params` over the mesh: one all-reduce of
    one flat buffer a dtype, then divided by the mesh size (JAX's psum
    over "data", where the JAX step places it). Every rank's loss is the
    mean over its block of the batch, the blocks of images are equal, and
    under a "spatial" axis each band's terms are spatial × its share of
    the image's (bands of any height; losses/), the terms whose counts
    differ between ranks scaling themselves to that rule, so the average
    is the gradient of the global loss. A parameter without a
    gradient is left without one: which parameters the loss reads is a
    property of the step's graph, the same on every rank."""
    if not mesh.distributed:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        flat = flat / mesh.size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def global_means(mesh: Optional[Mesh], metrics: Dict[str, torch.Tensor],
                 weight: Optional[torch.Tensor] = None, weighted=()
                 ) -> Dict[str, torch.Tensor]:
    """Every rank's `metrics` (0-dim tensors) -> their mean over the mesh,
    one all-reduce for all, each in its own dtype. The keys in `weighted`
    are weighted by their rank's `weight` instead (the depth metrics: a
    mean over the images that have ground truth). The metrics themselves
    without a distributed mesh."""
    if mesh is None or not mesh.distributed:
        return metrics
    keys = list(metrics)
    values = [metrics[k].double() * (weight.double() if k in weighted else 1.0)
              for k in keys]
    if weighted:
        values.append(weight.double())
    sums = mesh.all_reduce_(torch.stack(values))
    total = torch.clamp(sums[-1], min=1.0) if weighted else None
    return {k: (sums[i] / (total if k in weighted else mesh.size)).to(metrics[k].dtype)
            for i, k in enumerate(keys)}


# the keys of a step's inputs that hold the batch (batch_to_device reads
# them), and those that hold the train step's host values as tensors
# (TrainStep.host_values)
BATCH_KEYS = ("tgt", "ref_imgs", "intrinsics", "oxts", "groundtruth")
HOST_KEYS = ("ident_scale", "lr", "aug_add", "aug_scale", "aug_flip")
# the counter (utils/profiling.counter) of the bytes a train step's eager
# call saved for its backward
SAVED_BYTES = "train.saved_bytes"


class TrainStep:
    """step(batch) -> metrics {loss, mul_app_loss, smoothness_loss[,
    automask_keep][, warp_in_frame][, supervised_loss]} as 0-dim tensors
    (no host sync): one optimizer step. automask_keep ('min' only) is the
    fraction of pixels whose warp error wins the joint-min automask;
    warp_in_frame (with_coverage) the fraction of the warp's samples that
    land in the image, the port's stand-in for JAX's coverage metrics.

    The body of the JAX make_train_step_body: uint8 images normalized on
    the device; with color_jitter / hflip, the augmentations of
    data/augment.py on the normalized batch, their parameters drawn from
    (aug_seed, step) at the micro-batch's size (a CPU generator) and
    applied alike to every micro-batch; with
    semi_sup_pose, the batch's OXTS poses in place of the pose net's; the
    models in train mode under bf16 autocast (its weight cache off, as a
    CUDA graph needs) when
    precision is 'bf16'; disparities and poses cast to fp32 and the loss
    computed OUTSIDE the autocast region (autocast would otherwise run
    warp_coords' 3x3 products in bf16); the automask warm-up scale; the
    optional sparse-LiDAR term; gradient accumulation over accum_steps
    micro-batches (gradients summed, then averaged; BatchNorm statistics
    carried from one micro-batch to the next); then Adam and the schedule.
    The parameter gradients stay in .grad until the next step.

    The host computes the step's scalars (host_values: the warm-up scale,
    the learning rates, the augmentation draws) and hands them to the
    body as tensors with the batch; the body reads everything on the
    device. On a CUDA device without a mesh or under an NCCL mesh (`graph`
    None, the default) the body runs as CUDA graphs, one per input
    signature (train/graph.py): the first call of a batch shape is the
    eager step, the second captures it, later calls copy the batch and the
    host values into the graph's buffers and replay it; the gradients are
    then zeroed in place, not dropped, since a graph writes the same
    buffers at each replay. Under an NCCL mesh the graph holds the step's
    collectives, in the order every rank calls them: the BatchNorm sums
    (forward and backward), the 'ssim' clip threshold, the supervised
    mean, the halos and gathers of a spatial axis, the gradient
    all-reduce, the metric means. A captured step gives the eager step's
    bits. graph=False runs eagerly; graph=True on the CPU or under a gloo
    mesh raises. Loading a checkpoint into the optimizer, or dropping a
    gradient, drops the graphs: they read those tensors where they were
    captured.

    Under a data `mesh` (parallel/mesh.py) the step takes the global batch
    (or this rank's rows of it, a ShardedBatch from shard_batch or
    prefetch_to_device) and runs on this rank's rows: its BatchNorms take
    the global batch's statistics, the 'ssim' clip threshold and the
    supervised mean are global, the augmentations take this rank's rows of
    the draws at the GLOBAL micro-batch size, the gradients are averaged
    over the mesh once after the micro-batch loop, and the metrics are the
    global means on every rank — the JAX step on the global batch.
    Under a mesh with a "spatial" axis the ranks of a data row hold bands
    of the same images: the step gathers the whole frames from the bands
    (whole_frames), augments them with the draws of the data row's images,
    runs the depth net on its band (bind_spatial) and the pose net on the
    whole frames, and the loss on its band (losses/total.py).

    With remat the loss of each micro-batch is rematerialized, the
    counterpart of the JAX step's jax.checkpoint(loss_fn):
    torch.utils.checkpoint (non-reentrant, no early stop) keeps only its
    inputs and recomputes its forward in the backward. The recompute
    leaves the BatchNorm running statistics alone
    (layers.frozen_running_statistics) and draws no random numbers (the
    augmentation draws come before the loss); under a mesh it runs the
    same halo and BatchNorm all-reduces in the same order on every rank.
    The loss and the gradient are those without remat; only memory and
    time change.

    The first call of each input signature (the eager one where the step
    runs as CUDA graphs) counts the bytes that autograd saves for its
    backward, the weights left out: saved_bytes, and the counter
    SAVED_BYTES (counting_saved). Later calls count nothing.
    """

    def __init__(
        self,
        state: TrainState,
        loss_mode: str = "mean",
        semi_sup_pose: bool = False,
        smooth_weight: float = 1.0,
        smooth_on: str = "depth",
        depth_norm: bool = False,
        automask_warmup: int = 0,
        no_ssim: bool = False,
        min_bidirectional: bool = True,
        supervised_weight: float = 0.0,
        accum_steps: int = 1,
        remat: bool = False,
        color_jitter: bool = False,
        hflip: bool = False,
        aug_seed: int = 0,
        precision: str = "fp32",
        with_coverage: bool = False,
        mesh: Optional[Mesh] = None,
        device: str | torch.device = "cuda",
        graph: Optional[bool] = None,
        pool=None,
    ):
        _check_precision(precision)
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        self.device = resolve_device(device)
        self.state = state
        self.mesh = mesh
        bind_batch_norm((state.depth_model, state.pose_model), mesh)
        bind_spatial((state.depth_model, state.pose_model), mesh)
        self.loss_mode = loss_mode
        self.semi_sup_pose = semi_sup_pose
        self.smooth_weight = smooth_weight
        self.smooth_on = smooth_on
        self.depth_norm = depth_norm
        self.automask_warmup = automask_warmup
        self.no_ssim = no_ssim
        self.min_bidirectional = min_bidirectional
        self.supervised_weight = supervised_weight
        self.accum_steps = accum_steps
        self.remat = remat
        self.color_jitter = color_jitter
        self.hflip = hflip
        self.aug_seed = aug_seed
        self.precision = precision
        self.with_coverage = with_coverage
        self.graphs = (StepGraphs(self.device, pool)
                       if graph_enabled(graph, self.device, mesh) else None)
        self._captured_state: List = []
        # bytes saved for the backward by the latest eager call of a new
        # signature (counting_saved); None until the first step
        self.saved_bytes: Optional[int] = None
        self._counted: set = set()  # signatures counted without graphs

    def _ident_scale(self, step: int) -> float:
        if not (self.automask_warmup and self.loss_mode == "min"):
            return 1.0
        return automask_ident_scale(step, self.automask_warmup)

    def loss_fn(self, batch: Dict[str, torch.Tensor]):
        """(loss, reproj, smooth, extra) of one normalized (micro-)batch,
        which carries the step's automask scale as "ident_scale"."""
        state = self.state
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=self.precision == "bf16", cache_enabled=False):
            disps_tgt, disps_ref0, poses = forward_batch(
                state.depth_model, state.pose_model, batch, train=True,
                semi_sup_pose=self.semi_sup_pose,
                rows=band(self.mesh, batch["tgt"].shape[2]),
            )
        disps_tgt = [d.float() for d in disps_tgt]
        disps_ref0 = [d.float() for d in disps_ref0]
        reproj, smooth, extra = total_loss(
            batch["tgt"], [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]],
            [disps_tgt, disps_ref0], poses.float(), batch["intrinsics"],
            mode=self.loss_mode, smooth_weight=self.smooth_weight,
            smooth_on=self.smooth_on, depth_norm=self.depth_norm,
            ident_scale=batch["ident_scale"], no_ssim=self.no_ssim,
            min_bidirectional=self.min_bidirectional,
            with_coverage=self.with_coverage, mesh=self.mesh,
            scales=depth_scales(state.depth_model),
        )
        loss = reproj + smooth
        if self.supervised_weight and "groundtruth" in batch:
            sup = supervised_loss(disps_tgt[0], batch["groundtruth"], self.mesh)
            loss = loss + self.supervised_weight * sup
            extra["supervised_loss"] = sup
        return loss, reproj, smooth, extra

    def _rematerialized_loss(self, batch: Dict[str, torch.Tensor]):
        """loss_fn(batch) under torch.utils.checkpoint: its first call is
        the forward, any later one the backward's recompute."""
        calls = []

        def loss(micro):
            recompute = bool(calls)
            calls.append(1)
            if not recompute:
                return self.loss_fn(micro)
            with frozen_running_statistics():
                return self.loss_fn(micro)

        with set_checkpoint_early_stop(False):
            return checkpoint(loss, batch, use_reentrant=False, preserve_rng_state=False)

    def _aug_params(self, micro_size: int, step: int) -> Optional[AugmentParams]:
        """As in JAX, every micro-batch is augmented with the same draws:
        those of (aug_seed, step) at the GLOBAL micro-batch's size, of
        which this rank takes its images' rows — by its DATA index, so the
        bands of one image take the same draws."""
        if not (self.color_jitter or self.hflip):
            return None
        size = 1 if self.mesh is None else self.mesh.data_size
        params = draw_params(micro_size * size, self.aug_seed, step)
        if size == 1:
            return params
        index = self.mesh.data_rank
        rows = slice(index * micro_size, (index + 1) * micro_size)
        return AugmentParams(params.add[rows], params.scale[rows], params.flip[rows])

    def host_values(self, step: int, micro_size: int) -> Dict[str, torch.Tensor]:
        """The scalars of optimizer step `step` that the host computes, as
        CPU tensors: ident_scale, the automask warm-up scale (0-dim fp32,
        automask_ident_scale's bits; 1 without the warm-up); lr, each param
        group's learning rate as the scheduler has it now ([groups]; fp32 on
        the card, where capturable Adam reads it as optax does, fp64 on the
        CPU, the float's own bits); and with jitter or flips the draws of
        `step` for micro-batches of `micro_size` images (aug_add,
        aug_scale, aug_flip)."""
        lr_dtype = torch.float32 if self.device.type == "cuda" else torch.float64
        out = {"ident_scale": torch.tensor(self._ident_scale(step), dtype=torch.float32),
               "lr": torch.tensor([group["lr"] for group in self.state.optimizer.param_groups],
                                  dtype=lr_dtype)}
        aug = self._aug_params(micro_size, step)
        if aug is not None:
            out.update(aug_add=aug.add, aug_scale=aug.scale, aug_flip=aug.flip)
        return out

    def inputs(self, batch: Dict, step: int) -> Dict:
        """The body's inputs for `batch` (this rank's rows under a mesh) at
        optimizer step `step`: the batch's arrays that the step reads and
        host_values."""
        size = len(batch["tgt"])
        if size % self.accum_steps:
            raise ValueError("the batch size must be a multiple of accum_steps")
        keys = [k for k in BATCH_KEYS if k in batch
                and (k != "groundtruth" or self.supervised_weight)]
        return {**{k: batch[k] for k in keys},
                **self.host_values(step, size // self.accum_steps)}

    def body(self, inputs: Dict[str, torch.Tensor], height: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimizer step on `inputs` (from inputs(); host or device
        tensors) of images `height` rows tall (sharded_height: needed under
        a spatial axis only), without the host's part (the schedule,
        state.step): what a CUDA graph of the step captures."""
        state = self.state
        host = {k: inputs[k].to(self.device, non_blocking=True)
                for k in HOST_KEYS if k in inputs}
        batch = normalize_uint8_batch(whole_frames(self.mesh, batch_to_device(
            inputs, self.device, keep_groundtruth=bool(self.supervised_weight)
        ), state.depth_model, height))
        aug = (AugmentParams(host["aug_add"], host["aug_scale"], host["aug_flip"])
               if "aug_add" in host else None)
        state.optimizer.zero_grad(set_to_none=self.graphs is None)
        # micro-batch i is rows [i·mb, (i+1)·mb), the JAX reshape's order
        chunks = {k: v.chunk(self.accum_steps) for k, v in batch.items()}
        sums: Dict[str, torch.Tensor] = {}
        for i in range(self.accum_steps):
            micro = {k: v[i] for k, v in chunks.items()}
            if aug is not None:
                micro = augment_batch(micro, aug, jitter=self.color_jitter,
                                      flip=self.hflip)
            micro["ident_scale"] = host["ident_scale"]
            if self.remat:
                loss, reproj, smooth, extra = self._rematerialized_loss(micro)
            else:
                loss, reproj, smooth, extra = self.loss_fn(micro)
            loss.backward()
            values = {"loss": loss, "mul_app_loss": reproj,
                      "smoothness_loss": smooth, **extra}
            for k, v in values.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        scale = 1.0 / self.accum_steps
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        if self.accum_steps > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        if self.mesh is not None:
            all_reduce_gradients(self.mesh, params)
        with learning_rates(state.optimizer, host["lr"]):
            state.optimizer.step()
        return global_means(self.mesh, {k: v * scale for k, v in sums.items()})

    def run(self, body: Callable, inputs: Dict, height: Optional[int] = None
            ) -> Dict[str, torch.Tensor]:
        """body(inputs, height), through the step's CUDA graphs when it has
        them (the height is a graph key). The graphs hold the optimizer's
        state and the gradients where they were captured: a state loaded in
        their place drops them."""
        if self.graphs is None:
            signature = (height, *sorted((k, tuple(v.shape), str(v.dtype))
                                         for k, v in inputs.items()))
            if signature in self._counted:
                return body(inputs, height)
            self._counted.add(signature)
            with self.counting_saved():
                return body(inputs, height)
        held = self._graph_state()
        if (len(held) != len(self._captured_state)
                or any(a is not b for a, b in zip(held, self._captured_state))):
            self.graphs.reset()
        out = self.graphs(body, inputs, static=(height,), on_eager=self.counting_saved)
        self._captured_state = self._graph_state()
        return out

    @contextlib.contextmanager
    def counting_saved(self):
        """Count the bytes that autograd saves for the backward inside the
        block, the weights left out (utils/profiling.SavedBytes), into
        saved_bytes and the counter SAVED_BYTES. run() enters it around
        each signature's first call, the eager one, and around no other:
        a replay runs no host code. Under remat the checkpoint's own hooks
        take the loss's tensors, so what it keeps is what counts; with
        accumulation every micro-batch's saved storages add up."""
        state = self.state
        weights = [*state.depth_model.parameters(), *state.pose_model.parameters()]
        with SavedBytes(exclude=weights) as saved:
            yield
        self.saved_bytes = saved.bytes
        set_counter(SAVED_BYTES, saved.bytes)

    def _graph_state(self) -> List:
        optimizer = self.state.optimizer
        return [optimizer.state, optimizer.param_groups,
                *(p.grad for group in optimizer.param_groups for p in group["params"])]

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch`. Under a torch.profiler session it
        records the spans `train.step` (unit id: the optimizer step),
        `train.inputs` (inputs and host_values) and `train.schedule`
        (utils/profiling.annotate), around the step graphs' own."""
        state = self.state
        with annotate("train.step", state.step):
            if self.mesh is not None:
                batch = shard_batch(self.mesh, batch, self.accum_steps)
            with annotate("train.inputs"):
                inputs = self.inputs(batch, state.step)
            metrics = self.run(self.body, inputs, sharded_height(self.mesh, batch))
            with annotate("train.schedule"):
                state.scheduler.step()
            state.step += 1
        return metrics


def make_train_step(state: TrainState, device: str | torch.device = "cuda",
                    mesh: Optional[Mesh] = None, graph: Optional[bool] = None,
                    pool=None, **step_kwargs) -> TrainStep:
    """Build the train step over `state` (see TrainStep for step_kwargs
    and `graph`), under a data mesh when `mesh` is given; `pool` is the
    CUDA graphs' memory pool (train/graph.StepGraphs)."""
    return TrainStep(state, device=device, mesh=mesh, graph=graph, pool=pool,
                     **step_kwargs)


def make_multi_step(state: TrainState, num_steps: int, mesh: Optional[Mesh] = None,
                    device: str | torch.device = "cuda", graph: Optional[bool] = None,
                    pool=None, **step_kwargs):
    """multi(batches) -> the LAST step's metrics, after `num_steps` full
    optimizer steps in order: batches is one batch dict whose arrays have
    a leading [num_steps] axis ([num_steps, B, ...]), step i taking
    batches[k][i]. Under a mesh the batch axis (axis 1) is sharded.

    The counterpart of the JAX make_multi_step, which scans the steps
    inside one program: the host computes every step's scalars first
    (TrainStep.host_values, stacked [num_steps, ...]: step i's warm-up
    scale, learning rate and draws in slot i; the schedule stepped
    num_steps times), and one body runs the num_steps train-step bodies in
    order, step i reading slot i. On a CUDA device without a mesh or under
    an NCCL mesh that body is ONE CUDA graph (`graph` as in TrainStep):
    one replay, one launch, makes num_steps updates. multi.train_step is the TrainStep
    whose body it runs (its graphs: multi.train_step.graphs)."""
    step = make_train_step(state, device=device, mesh=mesh, graph=graph, pool=pool,
                           **step_kwargs)

    def steps(inputs: Dict[str, torch.Tensor], height: Optional[int] = None
              ) -> Dict[str, torch.Tensor]:
        metrics = None
        for i in range(num_steps):
            metrics = step.body({k: v[i] for k, v in inputs.items()}, height)
        return metrics

    def multi(batches: Dict) -> Dict[str, torch.Tensor]:
        if mesh is not None:
            batches = shard_batch(mesh, batches, step.accum_steps, batch_axis=1)
        sizes = {len(v) for v in batches.values()}
        if sizes != {num_steps}:
            raise ValueError(f"batches of leading size {sizes}, expected {num_steps}")
        slots = []
        with warnings.catch_warnings():
            # the schedule runs ahead of the optimizer here, by design: the
            # host reads each step's learning rate before the steps run
            warnings.filterwarnings("ignore", "Detected call of `lr_scheduler")
            for i in range(num_steps):
                slots.append(step.inputs({k: v[i] for k, v in batches.items()},
                                         state.step + i))
                state.scheduler.step()
        inputs = {k: (torch.stack([s[k] for s in slots]) if k in HOST_KEYS else batches[k])
                  for k in slots[0]}
        metrics = step.run(steps, inputs, sharded_height(mesh, batches))
        state.step += num_steps
        return metrics

    multi.train_step = step
    return multi


# --------------------------------------------------------------------------
# validation
# --------------------------------------------------------------------------


class EvalStep:
    """step(batch) -> (metrics {name: 0-dim tensor}, depth_pred [B, H, W]).

    The models run in eval mode, under bf16 autocast when precision is
    'bf16'; their outputs are cast to fp32 before the loss, which always
    runs in fp32. As in the JAX eval step, the loss takes total_loss'
    defaults for everything but the mode and depth_norm: smoothness on the
    (normalized, with depth_norm) depth at weight 1.0 — not the training
    config's smoothness settings — and the bidirectional automask.

    metrics: "loss"; with pose_metrics and `oxts` in the batch,
    pose_{ate, ate_unscaled, rot_err_deg, scale} of the poses the loss used
    against oxts (eval/pose.py; with semi_sup_pose the loss uses the oxts
    poses themselves, so these are 0 by construction); with `groundtruth` in the batch the depth
    metrics of eval/metrics.py (silog, abs_rel, log10, rms, sq_rel,
    log_rms, d1, d2, d3), median-scaled when median_scale is set.
    eval_protocol 'eigen' is the KITTI Eigen-split monocular protocol:
    the Garg crop, ground truth in (1e-3, 80) m and per-image median
    scaling.

    Under a data `mesh` each rank evaluates its rows of the batch, and the
    metrics are the global batch's on every rank: the loss and pose
    metrics averaged over the ranks (the 'ssim' clip threshold global),
    the depth metrics over the images that have ground truth; depth_pred
    holds this rank's images. Under a "spatial" axis the loss is taken on
    the band, as in the train step, and depth_pred and the ground truth
    are gathered to whole images for the depth metrics (median scaling
    and the Eigen crop are per whole image): every rank of a data row
    then holds its images' whole depth_pred.

    On a CUDA device without a mesh or under an NCCL mesh (`graph` None,
    the default) the step runs as CUDA graphs, one per batch signature, as
    TrainStep does (train/graph.py): the first call of a signature is
    eager, the second captures, later calls replay; the metrics and
    depth_pred returned are copies of the graph's. graph=False runs
    eagerly; graph=True on the CPU or under a gloo mesh raises."""

    def __init__(self, depth_model: nn.Module, pose_model: nn.Module,
                 loss_mode: str = "mean", depth_norm: bool = False,
                 precision: str = "fp32", median_scale: bool = False,
                 eval_protocol: str = "none", pose_metrics: bool = False,
                 semi_sup_pose: bool = False, mesh: Optional[Mesh] = None,
                 device: str | torch.device = "cuda", graph: Optional[bool] = None,
                 pool=None):
        _check_precision(precision)
        if eval_protocol not in ("none", "eigen"):
            raise ValueError(f"Unknown eval_protocol: {eval_protocol!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        bind_spatial((depth_model, pose_model), mesh)
        self.depth_model = depth_model.eval()
        self.pose_model = pose_model.eval()
        self.loss_mode = loss_mode
        self.depth_norm = depth_norm
        self.precision = precision
        self.eigen = eval_protocol == "eigen"
        self.median_scale = median_scale or self.eigen
        self.pose_metrics = pose_metrics
        self.semi_sup_pose = semi_sup_pose
        self.graphs = (StepGraphs(self.device, pool)
                       if graph_enabled(graph, self.device, mesh) else None)

    @torch.no_grad()
    def loss_inputs(self, batch: Dict, height: Optional[int] = None) -> Dict:
        """The fp32 tensors the loss consumes: normalized images, the two
        disparity lists, poses and intrinsics; and the batch's groundtruth
        and oxts when it has them. `height`: the global image height under
        a spatial axis; by default the one shard_batch recorded in `batch`
        (sharded_height)."""
        if height is None:
            height = sharded_height(self.mesh, batch)
        batch = normalize_uint8_batch(whole_frames(
            self.mesh, batch_to_device(batch, self.device, keep_groundtruth=True),
            self.depth_model, height))
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=self.precision == "bf16", cache_enabled=False):
            disps_tgt, disps_ref0, poses = forward_batch(
                self.depth_model, self.pose_model, batch, train=False,
                semi_sup_pose=self.semi_sup_pose,
                rows=band(self.mesh, batch["tgt"].shape[2]),
            )
        inputs = {
            "tgt": batch["tgt"],
            "refs": [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]],
            "disparities": [[d.float() for d in disps_tgt],
                            [d.float() for d in disps_ref0]],
            "poses": poses.float(),
            "intrinsics": batch["intrinsics"],
        }
        inputs.update({k: batch[k] for k in ("groundtruth", "oxts") if k in batch})
        return inputs

    @torch.no_grad()
    def loss(self, inputs: Dict) -> torch.Tensor:
        reproj, smooth, _ = total_loss(
            inputs["tgt"], inputs["refs"], inputs["disparities"],
            inputs["poses"], inputs["intrinsics"], mode=self.loss_mode,
            depth_norm=self.depth_norm, mesh=self.mesh, scales=depth_scales(self.depth_model),
        )
        return reproj + smooth

    def _depth_mask(self, gt: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.eigen:
            return None
        crop = eigen_crop_mask(gt.shape[-2], gt.shape[-1], gt.device)
        return crop & (gt > 1e-3) & (gt < 80.0)

    @torch.no_grad()
    def metrics(self, inputs: Dict, depth_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The pose and depth metrics of one batch's loss inputs."""
        out = {}
        if self.pose_metrics and "oxts" in inputs:
            errors = pose_errors(inputs["poses"], inputs["oxts"])
            out.update({f"pose_{k}": v for k, v in errors.items()})
        if "groundtruth" in inputs:
            out.update(compute_errors(inputs["groundtruth"], depth_pred,
                                      mask=self._depth_mask(inputs["groundtruth"]),
                                      median_scale=self.median_scale))
        return out

    def __call__(self, batch: Dict):
        if self.mesh is not None:
            batch = shard_batch(self.mesh, batch)
        height = sharded_height(self.mesh, batch)
        batch = {k: batch[k] for k in BATCH_KEYS if k in batch}
        if self.graphs is None:
            return self.body(batch, height)
        return self.graphs(self.body, batch, static=(height,))

    @torch.no_grad()
    def body(self, batch: Dict, height: Optional[int] = None):
        """(metrics, depth_pred) of a batch (this rank's rows under a
        mesh) of images `height` rows tall (sharded_height: needed under a
        spatial axis only): what a CUDA graph of the step captures."""
        inputs = self.loss_inputs(batch, height)
        depth_pred = disp_to_depth(inputs["disparities"][0][0][:, 0])
        if row_sharded(self.mesh):
            height = inputs["tgt"].shape[2]
            depth_pred = whole_rows(depth_pred, self.mesh, height)
            if "groundtruth" in inputs:
                inputs["groundtruth"] = gather_rows(inputs["groundtruth"], self.mesh, 1,
                                                    height)
        metrics = {"loss": self.loss(inputs), **self.metrics(inputs, depth_pred)}
        if self.mesh is None or "groundtruth" not in inputs:
            return global_means(self.mesh, metrics), depth_pred
        # compute_errors averages over the images with a valid pixel
        gt = inputs["groundtruth"]
        mask = self._depth_mask(gt)
        valid = (gt > 1e-3) & (gt < 80.0) if mask is None else mask
        with_gt = valid.flatten(1).any(dim=1).sum()
        return global_means(self.mesh, metrics, with_gt, METRICS), depth_pred


def make_eval_step(depth_model: nn.Module, pose_model: nn.Module,
                   loss_mode: str = "mean", depth_norm: bool = False,
                   precision: str = "fp32", median_scale: bool = False,
                   eval_protocol: str = "none", pose_metrics: bool = False,
                   semi_sup_pose: bool = False, mesh: Optional[Mesh] = None,
                   device: str | torch.device = "cuda", graph: Optional[bool] = None,
                   pool=None) -> EvalStep:
    """Build the validation step (see EvalStep for `graph`; `pool` is the
    CUDA graphs' memory pool, train/graph.StepGraphs)."""
    return EvalStep(depth_model, pose_model, loss_mode=loss_mode,
                    depth_norm=depth_norm, precision=precision,
                    median_scale=median_scale, eval_protocol=eval_protocol,
                    pose_metrics=pose_metrics, semi_sup_pose=semi_sup_pose,
                    mesh=mesh, device=device, graph=graph, pool=pool)


# --------------------------------------------------------------------------
# the epoch loop
# --------------------------------------------------------------------------


class Trainer:
    """Config -> models, optimizer, train and eval steps, checkpoints,
    epoch loop.

    The JAX Trainer. Weights come from a torch.Generator seeded with
    action.random_seed (then pretrained_path, when set). Checkpoints go to
    <action.checkpoint_dir>/<model.name>/epoch_<n>.pth
    (train/checkpoint.py); with action.from_scratch False the latest one
    is restored and training resumes at the epoch after it (checkpoints
    are written when an epoch ends).

    Under a data `mesh` (one Trainer a rank; parallel/mesh.py) the train
    and eval steps run under it, the state is replicated from rank 0
    after it is built and after a restore (every rank restores the same
    checkpoint), and only rank 0 logs (log_fn, wandb pictures and
    histograms) and writes checkpoints; the other ranks wait for it at
    the end of each epoch. Under a "spatial" axis the other ranks of its
    data row join it in the pictures' banded forward (fit, log_warps).

    `graph` is the steps' (TrainStep): on a CUDA device without a mesh
    or under an NCCL mesh they run as CUDA graphs by default, the train
    and eval graphs in one memory pool (they never run at the same
    time)."""

    def __init__(
        self,
        config: Config,
        dataset=None,
        log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
        device: str | torch.device = "cuda",
        mesh: Optional[Mesh] = None,
        graph: Optional[bool] = None,
    ):
        act = config.action
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.log_fn = log_fn if self.is_main else None
        self.epoch = 0
        self.batch_waits: List[float] = []
        self._last_batch = None
        self.steps_per_epoch = (
            max(1, len(dataset) // act.batch_size) if dataset is not None else 1000
        )
        generator = torch.Generator().manual_seed(act.random_seed)
        self.state = create_train_state(config, generator, self.steps_per_epoch,
                                        self.device)
        if mesh is not None:
            shard_train_state(mesh, self.state)
        aug = config.datasets.augmentation
        pool = (torch.cuda.graph_pool_handle()
                if graph_enabled(graph, self.device, mesh) else None)
        self.train_step = make_train_step(
            self.state, device=self.device, mesh=mesh, graph=graph, pool=pool,
            loss_mode=act.loss_mode,
            semi_sup_pose=act.semi_sup_pose, smooth_weight=act.smooth_weight,
            smooth_on=act.smooth_on, depth_norm=act.depth_norm,
            automask_warmup=act.automask_warmup, no_ssim=act.no_ssim,
            min_bidirectional=act.min_bidirectional,
            supervised_weight=act.supervised_weight,
            accum_steps=act.accum_steps, remat=act.remat,
            color_jitter=aug.color_jitter, hflip=aug.hflip,
            aug_seed=act.random_seed, precision=act.precision,
            # JAX reports its warp coverage with the banded warps
            with_coverage=act.warp_impl in ("mxu", "pallas"),
        )
        self.eval_step = make_eval_step(
            self.state.depth_model, self.state.pose_model,
            loss_mode=act.loss_mode, depth_norm=act.depth_norm,
            precision=act.precision, median_scale=act.eval_median_scale,
            eval_protocol=act.eval_protocol, pose_metrics=act.eval_pose,
            semi_sup_pose=act.semi_sup_pose, mesh=mesh, device=self.device,
            graph=graph, pool=pool,
        )
        self.checkpoints = CheckpointManager(
            os.path.join(act.checkpoint_dir, config.model.name)
        )
        if not act.from_scratch:
            restored = self.checkpoints.restore(self.state)
            if restored is not None:
                self.epoch = restored + 1
            if mesh is not None:
                shard_train_state(mesh, self.state)

    def run_epoch(self, train_batches) -> Dict[str, float]:
        """One pass over an iterable of host batches -> the last step's
        metrics as floats (read from the device once, at the end).
        self.batch_waits holds the seconds the loop waited for each batch
        of the epoch (host clock; the steps before it run on unawaited).
        The epoch's last batch is kept for fit's warp pictures; a read
        warp_in_frame of 0.0 warns once (_warn_if_collapsed)."""
        metrics = None
        self.batch_waits = []
        self._last_batch = None  # never carry a stale batch across epochs
        batches = iter(train_batches)
        for i in itertools.count():
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            self.batch_waits.append(time.perf_counter() - t0)
            self._last_batch = batch
            metrics = self.train_step(batch)
            if self.log_fn is not None and (i + 1) % self.config.action.log_freq == 0:
                self.log_fn({k: float(v) for k, v in metrics.items()},
                            self.state.step)
        if metrics is None:  # empty iterator
            return {}
        out = {k: float(v) for k, v in metrics.items()}
        self._warn_if_collapsed(out)
        return out

    def _warn_if_collapsed(self, metrics: Dict[str, float]) -> None:
        """Warn once when training has fallen into the zeros-warp trivial
        solution: the zeros-padded 'mean' objective is minimized by pushing
        every warp sample out of frame, after which the warped image is all
        zeros, the loss is frozen at mean|tgt| and no gradient flows back
        through the out-of-frame taps. warp_in_frame reads exactly 0.0 only
        when no sample lands in the image. 'min' is immune: its joint-min
        automask leaves an out-of-frame warp at the identity-error floor."""
        if getattr(self, "_collapse_warned", False):
            return
        if metrics.get("warp_in_frame") == 0.0:
            self._collapse_warned = True
            print(
                "[trainer] WARNING: warp coverage is 0.0 — every sample "
                "projects out of frame, so the photometric gradient is "
                "dead and the loss is frozen at mean|tgt| (the zeros-warp "
                "trivial solution of the zeros-padded 'mean' objective). "
                "Training cannot recover from here. Restart with "
                "action.loss_mode: 'min' (its joint-min automask leaves "
                "an out-of-frame warp at the identity-error floor, never "
                "an improvement) and smooth_on: 'disp' — see "
                "benchmarks/reference_loop.py and docs/DESIGN.md §8.",
                flush=True,
            )

    @torch.no_grad()
    def warp_pictures(self, batch) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The first sample's target [H, W, 3], ref0 warped into the target
        frame with pose 0 [H, W, 3] (kernel A on the card) and depth
        [H, W], as numpy arrays: what log_warps renders. The models run in
        eval mode, as in JAX; the batch is normalized first, so a uint8
        batch renders as a float one.

        Under a mesh with a "spatial" axis every rank of the first data
        row must call it: each runs the depth net on its band of that
        row's images (the halo convolutions need all of them), the bands
        of the first image's depth are gathered (gather_rows), and rank 0
        warps and returns the arrays; the other ranks return None."""
        act = self.config.action
        sharded = row_sharded(self.mesh)
        if sharded:
            batch = shard_batch(self.mesh, batch, self.train_step.accum_steps)
        batch = normalize_uint8_batch(whole_frames(
            self.mesh, batch_to_device(batch, self.device), self.state.depth_model,
            sharded_height(self.mesh, batch)))
        height = batch["tgt"].shape[2]
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=act.precision == "bf16", cache_enabled=False):
            disps_tgt, _, poses = forward_batch(
                self.state.depth_model, self.state.pose_model, batch, train=False,
                semi_sup_pose=act.semi_sup_pose, rows=band(self.mesh, height),
            )
        depth = disp_to_depth(disps_tgt[0][:1, 0].float())
        if sharded:
            depth = whole_rows(depth, self.mesh, height)
            if self.mesh.rank != 0:
                return None
        warped = inverse_warp(batch["ref_imgs"][:1, 0], depth, poses[:1, 0].float(),
                              batch["intrinsics"][:1])

        def hwc(x):
            return x[0].permute(1, 2, 0).cpu().numpy()

        return hwc(batch["tgt"]), hwc(warped), depth[0].cpu().numpy()

    def log_warps(self, batch, step: int = 0, out_dir: str = "./images"
                  ) -> Optional[Dict[str, str]]:
        """Render warp_pictures(batch) as PNGs under out_dir
        (utils/visualization.save_warp_visualization); returns {file name:
        path}, or None on a rank that renders nothing (under a spatial
        mesh every rank of the first data row calls it and rank 0
        renders; warp_pictures)."""
        from unsupervised_pseuso_lidar_tpu_torch.utils.visualization import (
            save_warp_visualization,
        )

        pictures = self.warp_pictures(batch)
        if pictures is None:
            return None
        return save_warp_visualization(out_dir, step, *pictures)

    def validate(self, val_batches) -> Dict[str, float]:
        """Mean of the eval step's metrics over an iterable of batches (the
        batches' groundtruth and oxts included), read from the device once."""
        sums: Dict[str, List[torch.Tensor]] = {}
        count = 0
        for batch in val_batches:
            metrics, _ = self.eval_step(batch)
            for k, v in metrics.items():
                sums.setdefault(k, []).append(v)
            count += 1
        return {k: float(torch.stack(v).sum() / max(count, 1))
                for k, v in sums.items()}

    def fit(self, make_train_iter, make_val_iter=None) -> Dict[str, float]:
        """Train from self.epoch to action.num_epochs: each epoch runs
        make_train_iter(epoch), then validates on make_val_iter() (when
        given) and logs; with a wandb logger it also logs the warp pictures
        of the epoch's last batch (log_warps) and the weight histograms;
        then it saves a checkpoint. A SIGTERM or SIGINT
        during an epoch lets it finish, checkpoints it and stops (resume
        with from_scratch: False). Returns the last epoch's metrics.

        Under a mesh rank 0 alone saves, logs and renders; then the ranks
        all-reduce their interrupt flags, which is also where the others
        wait for the save, so a signal to any rank stops every rank after
        the same checkpoint. Under a "spatial" axis the ranks learn once
        whether rank 0 logs pictures, and every rank of the first data row
        then runs log_warps with it (its banded forward needs them all)."""
        wandb_logger = getattr(self.log_fn, "_wandb", None) is not None
        draws = wandb_logger
        if row_sharded(self.mesh):
            flag = torch.tensor([float(wandb_logger)], device=self.mesh.device)
            draws = float(self.mesh.all_reduce_(flag)) > 0 and self.mesh.data_rank == 0
        interrupted = []
        previous = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, lambda *_: interrupted.append(1))
        except ValueError:  # not the main thread: no handlers
            pass
        metrics: Dict[str, float] = {}
        try:
            for self.epoch in range(self.epoch, self.config.action.num_epochs):
                metrics = self.run_epoch(make_train_iter(self.epoch))
                if make_val_iter is not None:
                    val = self.validate(make_val_iter())
                    metrics.update({f"val_{k}": v for k, v in val.items()})
                    if self.log_fn is not None:
                        self.log_fn(metrics, self.state.step)
                if draws and self._last_batch is not None:
                    paths = self.log_warps(self._last_batch, step=self.state.step)
                    if wandb_logger:
                        self.log_fn.log_images(paths, self.state.step)
                if wandb_logger:
                    self.log_fn.log_param_histograms(
                        {"depth": self.state.depth_model, "pose": self.state.pose_model},
                        self.state.step)
                if self.is_main:
                    self.checkpoints.save(self.state, self.epoch)
                if self.mesh is not None:
                    flag = torch.tensor([float(len(interrupted))], device=self.mesh.device)
                    if float(self.mesh.all_reduce_(flag)) > 0:
                        interrupted.append(1)
                if interrupted:
                    print(f"[trainer] interrupted: checkpointed epoch {self.epoch}",
                          flush=True)
                    break
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
        return metrics
