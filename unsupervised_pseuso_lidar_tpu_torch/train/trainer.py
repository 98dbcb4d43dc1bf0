"""Training runtime: state, train step, validation step, epoch loop.

Counterpart of unsupervised_pseuso_lidar_tpu/train/trainer.py
(make_lr_schedule :58, make_optimizer :66, create_train_state :99,
forward_batch :164, normalize_uint8_batch :213, make_train_step_body
:231-401, make_eval_step :480, Trainer :561, _warn_if_collapsed :683,
log_warps :742, fit :783, make_multi_step :447). Under a data mesh
(parallel/mesh.py; `mesh=` of TrainStep, EvalStep, make_multi_step and
Trainer) each rank runs the step on its rows of the global batch and the
result is the JAX step's on the global batch: BatchNorm statistics, the
'ssim' clip threshold and the supervised masked mean are all-reduced
where they are taken, the parameter gradients are averaged once a step
before the optimizer, and the metrics are global means on every rank.

Batches use the JAX package's schema and layout — tgt [B, H, W, 3],
ref_imgs [B, 2, H, W, 3] (uint8 or ImageNet-normalized float),
intrinsics [B, 3, 3], optionally oxts [B, 2, 6] and groundtruth
[B, H, W] — as numpy arrays or tensors; `batch_to_device` moves them to
the device as NCHW tensors.
"""

from __future__ import annotations

import inspect
import itertools
import os
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

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
from unsupervised_pseuso_lidar_tpu_torch.models.layers import BatchNorm2d
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBatch,
    shard_batch,
    shard_train_state,
)
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_pretrained_depth,
    load_pretrained_pose,
)
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import abs_
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
        "intrinsics": to(batch["intrinsics"]).to(device, torch.float32),
    }
    if "oxts" in batch:
        out["oxts"] = to(batch["oxts"]).to(device, torch.float32)
    if keep_groundtruth and "groundtruth" in batch:
        out["groundtruth"] = to(batch["groundtruth"]).to(device, torch.float32)
    return out


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
    depth_model: nn.Module,
    pose_model: nn.Module,
    batch: Dict[str, torch.Tensor],
    train: bool = False,
    semi_sup_pose: bool = False,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Depth (tgt and ref0 stacked into one 2B pass, so train-mode
    BatchNorm statistics come from the joint batch, as in JAX) and pose
    forward on a normalized NCHW batch, the models in train or eval mode
    -> (disps_tgt, disps_ref0, poses). With semi_sup_pose the poses are
    the batch's OXTS odometry [B, 2, 6] and the pose net does not run (so
    it gets no gradient)."""
    depth_model.train(train)
    pose_model.train(train)
    tgt = batch["tgt"]
    ref0 = batch["ref_imgs"][:, 0]
    ref1 = batch["ref_imgs"][:, 1]
    bsz = tgt.shape[0]
    disps = depth_model(torch.cat([tgt, ref0], dim=0))
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
    one param group per net when depth_lr != pose_lr."""
    opt = config.action.optimizer
    depth_params = list(depth_model.parameters())
    pose_params = list(pose_model.parameters())
    if opt.depth_lr == opt.pose_lr:
        groups = [{"params": depth_params + pose_params, "lr": opt.depth_lr}]
    else:
        groups = [{"params": depth_params, "lr": opt.depth_lr},
                  {"params": pose_params, "lr": opt.pose_lr}]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


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


def all_reduce_gradients(mesh: Mesh, params) -> None:
    """Average the gradients of `params` over the mesh: one all-reduce of
    one flat buffer a dtype, then divided by the mesh size (JAX's psum
    over "data", where the JAX step places it). A parameter without a
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
    (aug_seed, step) at the micro-batch's size (a CPU generator, then moved
    to the device) and applied alike to every micro-batch; with
    semi_sup_pose, the batch's OXTS poses in place of the pose net's; the
    models in train mode under bf16 autocast when
    precision is 'bf16'; disparities and poses cast to fp32 and the loss
    computed OUTSIDE the autocast region (autocast would otherwise run
    warp_coords' 3x3 products in bf16); the automask warm-up scale; the
    optional sparse-LiDAR term; gradient accumulation over accum_steps
    micro-batches (gradients summed, then averaged; BatchNorm statistics
    carried from one micro-batch to the next); then Adam and the schedule.
    The parameter gradients stay in .grad until the next step.

    Under a data `mesh` (parallel/mesh.py) the step takes the global batch
    (or this rank's rows of it, a ShardedBatch from shard_batch or
    prefetch_to_device) and runs on this rank's rows: its BatchNorms take
    the global batch's statistics, the 'ssim' clip threshold and the
    supervised mean are global, the augmentations take this rank's rows of
    the draws at the GLOBAL micro-batch size, the gradients are averaged
    over the mesh once after the micro-batch loop, and the metrics are the
    global means on every rank — the JAX step on the global batch.

    remat is accepted and ignored (a memory knob of the JAX step).
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
    ):
        _check_precision(precision)
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        self.device = resolve_device(device)
        self.state = state
        self.mesh = mesh
        bind_batch_norm((state.depth_model, state.pose_model), mesh)
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
        self.color_jitter = color_jitter
        self.hflip = hflip
        self.aug_seed = aug_seed
        self.precision = precision
        self.with_coverage = with_coverage

    def _ident_scale(self) -> float:
        if not (self.automask_warmup and self.loss_mode == "min"):
            return 1.0
        return automask_ident_scale(self.state.step, self.automask_warmup)

    def loss_fn(self, batch: Dict[str, torch.Tensor]):
        """(loss, reproj, smooth, extra) of one normalized (micro-)batch."""
        state = self.state
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=self.precision == "bf16"):
            disps_tgt, disps_ref0, poses = forward_batch(
                state.depth_model, state.pose_model, batch, train=True,
                semi_sup_pose=self.semi_sup_pose,
            )
        disps_tgt = [d.float() for d in disps_tgt]
        disps_ref0 = [d.float() for d in disps_ref0]
        reproj, smooth, extra = total_loss(
            batch["tgt"], [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]],
            [disps_tgt, disps_ref0], poses.float(), batch["intrinsics"],
            mode=self.loss_mode, smooth_weight=self.smooth_weight,
            smooth_on=self.smooth_on, depth_norm=self.depth_norm,
            ident_scale=self._ident_scale(), no_ssim=self.no_ssim,
            min_bidirectional=self.min_bidirectional,
            with_coverage=self.with_coverage, mesh=self.mesh,
        )
        loss = reproj + smooth
        if self.supervised_weight and "groundtruth" in batch:
            sup = supervised_loss(disps_tgt[0], batch["groundtruth"], self.mesh)
            loss = loss + self.supervised_weight * sup
            extra["supervised_loss"] = sup
        return loss, reproj, smooth, extra

    def _aug_params(self, micro_size: int) -> Optional[AugmentParams]:
        """As in JAX, every micro-batch is augmented with the same draws:
        those of (aug_seed, step) at the GLOBAL micro-batch's size, of
        which this rank takes its rows."""
        if not (self.color_jitter or self.hflip):
            return None
        size = 1 if self.mesh is None else self.mesh.size
        params = draw_params(micro_size * size, self.aug_seed, self.state.step)
        if size == 1:
            return params
        rows = slice(self.mesh.rank * micro_size, (self.mesh.rank + 1) * micro_size)
        return AugmentParams(params.add[rows], params.scale[rows], params.flip[rows])

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        state = self.state
        if self.mesh is not None:
            batch = shard_batch(self.mesh, batch, self.accum_steps)
        batch = normalize_uint8_batch(batch_to_device(
            batch, self.device, keep_groundtruth=bool(self.supervised_weight)
        ))
        if batch["tgt"].shape[0] % self.accum_steps:
            raise ValueError("the batch size must be a multiple of accum_steps")
        aug = self._aug_params(batch["tgt"].shape[0] // self.accum_steps)
        state.optimizer.zero_grad(set_to_none=True)
        # micro-batch i is rows [i·mb, (i+1)·mb), the JAX reshape's order
        chunks = {k: v.chunk(self.accum_steps) for k, v in batch.items()}
        sums: Dict[str, torch.Tensor] = {}
        for i in range(self.accum_steps):
            micro = {k: v[i] for k, v in chunks.items()}
            if aug is not None:
                micro = augment_batch(micro, aug, jitter=self.color_jitter,
                                      flip=self.hflip)
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
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return global_means(self.mesh, {k: v * scale for k, v in sums.items()})


def make_train_step(state: TrainState, device: str | torch.device = "cuda",
                    mesh: Optional[Mesh] = None, **step_kwargs) -> TrainStep:
    """Build the train step over `state` (see TrainStep for step_kwargs),
    under a data mesh when `mesh` is given."""
    return TrainStep(state, device=device, mesh=mesh, **step_kwargs)


def make_multi_step(state: TrainState, num_steps: int, mesh: Optional[Mesh] = None,
                    device: str | torch.device = "cuda", **step_kwargs):
    """multi(batches) -> the LAST step's metrics, after `num_steps` full
    optimizer steps in order: batches is one batch dict whose arrays have
    a leading [num_steps] axis ([num_steps, B, ...]), step i taking
    batches[k][i]. Under a mesh the batch axis (axis 1) is sharded. A
    plain loop over TrainStep: no host sync between the steps; the JAX
    counterpart scans the steps inside one program (capturing this loop
    in a CUDA graph is not done)."""
    step = make_train_step(state, device=device, mesh=mesh, **step_kwargs)

    def multi(batches: Dict) -> Dict[str, torch.Tensor]:
        if mesh is not None:
            batches = shard_batch(mesh, batches, step.accum_steps, batch_axis=1)
        sizes = {len(v) for v in batches.values()}
        if sizes != {num_steps}:
            raise ValueError(f"batches of leading size {sizes}, expected {num_steps}")
        metrics = None
        for i in range(num_steps):
            batch = {k: v[i] for k, v in batches.items()}
            if mesh is not None:
                batch = ShardedBatch(batch, step.accum_steps)
            metrics = step(batch)
        return metrics

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
    holds this rank's rows."""

    def __init__(self, depth_model: nn.Module, pose_model: nn.Module,
                 loss_mode: str = "mean", depth_norm: bool = False,
                 precision: str = "fp32", median_scale: bool = False,
                 eval_protocol: str = "none", pose_metrics: bool = False,
                 semi_sup_pose: bool = False, mesh: Optional[Mesh] = None,
                 device: str | torch.device = "cuda"):
        _check_precision(precision)
        if eval_protocol not in ("none", "eigen"):
            raise ValueError(f"Unknown eval_protocol: {eval_protocol!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.depth_model = depth_model.eval()
        self.pose_model = pose_model.eval()
        self.loss_mode = loss_mode
        self.depth_norm = depth_norm
        self.precision = precision
        self.eigen = eval_protocol == "eigen"
        self.median_scale = median_scale or self.eigen
        self.pose_metrics = pose_metrics
        self.semi_sup_pose = semi_sup_pose

    @torch.no_grad()
    def loss_inputs(self, batch: Dict) -> Dict:
        """The fp32 tensors the loss consumes: normalized images, the two
        disparity lists, poses and intrinsics; and the batch's groundtruth
        and oxts when it has them."""
        batch = normalize_uint8_batch(
            batch_to_device(batch, self.device, keep_groundtruth=True)
        )
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=self.precision == "bf16"):
            disps_tgt, disps_ref0, poses = forward_batch(
                self.depth_model, self.pose_model, batch, train=False,
                semi_sup_pose=self.semi_sup_pose,
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
            depth_norm=self.depth_norm, mesh=self.mesh,
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
        inputs = self.loss_inputs(batch)
        depth_pred = disp_to_depth(inputs["disparities"][0][0][:, 0])
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
                   device: str | torch.device = "cuda") -> EvalStep:
    """Build the validation step (see EvalStep)."""
    return EvalStep(depth_model, pose_model, loss_mode=loss_mode,
                    depth_norm=depth_norm, precision=precision,
                    median_scale=median_scale, eval_protocol=eval_protocol,
                    pose_metrics=pose_metrics, semi_sup_pose=semi_sup_pose,
                    mesh=mesh, device=device)


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
    the end of each epoch."""

    def __init__(
        self,
        config: Config,
        dataset=None,
        log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
        device: str | torch.device = "cuda",
        mesh: Optional[Mesh] = None,
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
        self.train_step = make_train_step(
            self.state, device=self.device, mesh=mesh, loss_mode=act.loss_mode,
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
    def log_warps(self, batch, step: int = 0, out_dir: str = "./images") -> Dict[str, str]:
        """Render the first sample's target, ref0 warped into the target
        frame (pose 0, kernel A on the card) and depth as PNGs under
        out_dir (utils/visualization.save_warp_visualization); returns
        {file name: path}. The models run in eval mode, as in JAX; the
        batch is normalized first, so a uint8 batch renders as a float one."""
        from unsupervised_pseuso_lidar_tpu_torch.utils.visualization import (
            save_warp_visualization,
        )

        act = self.config.action
        batch = normalize_uint8_batch(batch_to_device(batch, self.device))
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=act.precision == "bf16"):
            disps_tgt, _, poses = forward_batch(
                self.state.depth_model, self.state.pose_model, batch, train=False,
                semi_sup_pose=act.semi_sup_pose,
            )
        depth = disp_to_depth(disps_tgt[0][:, 0].float())
        warped = inverse_warp(batch["ref_imgs"][:, 0], depth, poses[:, 0].float(),
                              batch["intrinsics"])

        def hwc(x):
            return x[0].permute(1, 2, 0).cpu().numpy()

        return save_warp_visualization(out_dir, step, hwc(batch["tgt"]), hwc(warped),
                                       depth[0].cpu().numpy())

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

        Under a mesh rank 0 alone saves; then the ranks all-reduce their
        interrupt flags, which is also where the others wait for the save,
        so a signal to any rank stops every rank after the same
        checkpoint."""
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
                if getattr(self.log_fn, "_wandb", None) is not None:
                    if self._last_batch is not None:
                        paths = self.log_warps(self._last_batch, step=self.state.step)
                        self.log_fn.log_images(paths, self.state.step)
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
