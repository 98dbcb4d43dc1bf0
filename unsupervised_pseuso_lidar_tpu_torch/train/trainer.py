"""Training runtime: state, train step, validation step, epoch loop.

Counterpart of unsupervised_pseuso_lidar_tpu/train/trainer.py
(make_lr_schedule :58, make_optimizer :66, create_train_state :99,
forward_batch :164, normalize_uint8_batch :213, make_train_step_body
:231-401, make_eval_step :480, Trainer :561). Checkpoints, wandb logging,
the mesh and the multi-step scan are not ported yet; ground-truth depth and
pose metrics come with the evaluation slice, so the eval step ignores
`groundtruth` and `oxts` in a batch.

Batches use the JAX package's schema and layout — tgt [B, H, W, 3],
ref_imgs [B, 2, H, W, 3] (uint8 or ImageNet-normalized float),
intrinsics [B, 3, 3], optionally groundtruth [B, H, W] — as numpy arrays or
tensors; `batch_to_device` moves them to the device as NCHW tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import disp_to_depth
from unsupervised_pseuso_lidar_tpu_torch.losses.total import total_loss
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)


def batch_to_device(
    batch: Dict, device: torch.device, keep_groundtruth: bool = False
) -> Dict[str, torch.Tensor]:
    """{tgt [B,H,W,3], ref_imgs [B,2,H,W,3], intrinsics} (numpy or
    tensors) -> tensors on `device`: tgt [B,3,H,W], ref_imgs [B,2,3,H,W].
    uint8 images stay uint8 (a quarter of the fp32 bytes to copy).
    keep_groundtruth also moves groundtruth [B, H, W] (fp32) when present."""
    def to(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)

    tgt = to(batch["tgt"]).to(device, non_blocking=True)
    refs = to(batch["ref_imgs"]).to(device, non_blocking=True)
    out = {
        "tgt": tgt.permute(0, 3, 1, 2).contiguous(),
        "ref_imgs": refs.permute(0, 1, 4, 2, 3).contiguous(),
        "intrinsics": to(batch["intrinsics"]).to(device, torch.float32),
    }
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
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Depth (tgt and ref0 stacked into one 2B pass, so train-mode
    BatchNorm statistics come from the joint batch, as in JAX) and pose
    forward on a normalized NCHW batch, the models in train or eval mode
    -> (disps_tgt, disps_ref0, poses)."""
    depth_model.train(train)
    pose_model.train(train)
    tgt = batch["tgt"]
    ref0 = batch["ref_imgs"][:, 0]
    ref1 = batch["ref_imgs"][:, 1]
    bsz = tgt.shape[0]
    disps = depth_model(torch.cat([tgt, ref0], dim=0))
    disps_tgt = [d[:bsz] for d in disps]
    disps_ref0 = [d[bsz:] for d in disps]
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
    """Models (weights drawn from `generator`), optimizer and schedule on
    `device`."""
    device = resolve_device(device)
    for head in (config.model.depth, config.model.pose):
        if head.pretrained_path:
            raise NotImplementedError(
                "pretrained_path: loading a pretrained init is not ported yet"
            )
    depth_model = build_model(config.model.depth.name, generator, device,
                              **config.model.depth.kwargs)
    pose_model = build_model(config.model.pose.name, generator, device,
                             **config.model.pose.kwargs)
    optimizer = make_optimizer(config, depth_model, pose_model)
    sched = config.action.scheduler
    scheduler = make_lr_schedule(optimizer, sched.step_size, sched.gamma,
                                 steps_per_epoch)
    return TrainState(depth_model, pose_model, optimizer, scheduler)


class TrainStep:
    """step(batch) -> metrics {loss, mul_app_loss, smoothness_loss[,
    supervised_loss]} as 0-dim tensors (no host sync): one optimizer step.

    The body of the JAX make_train_step_body: uint8 images normalized on
    the device; the models in train mode under bf16 autocast when
    precision is 'bf16'; disparities and poses cast to fp32 and the loss
    computed OUTSIDE the autocast region (autocast would otherwise run
    warp_coords' 3x3 products in bf16); the automask warm-up scale; the
    optional sparse-LiDAR term; gradient accumulation over accum_steps
    micro-batches (gradients summed, then averaged; BatchNorm statistics
    carried from one micro-batch to the next); then Adam and the schedule.
    The parameter gradients stay in .grad until the next step.

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
        precision: str = "fp32",
        device: str | torch.device = "cuda",
    ):
        for flag, name in ((semi_sup_pose, "semi_sup_pose"),
                           (color_jitter, "color_jitter"), (hflip, "hflip")):
            if flag:
                raise NotImplementedError(f"{name} is not ported yet")
        _check_precision(precision)
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        self.device = resolve_device(device)
        self.state = state
        self.loss_mode = loss_mode
        self.smooth_weight = smooth_weight
        self.smooth_on = smooth_on
        self.depth_norm = depth_norm
        self.automask_warmup = automask_warmup
        self.no_ssim = no_ssim
        self.min_bidirectional = min_bidirectional
        self.supervised_weight = supervised_weight
        self.accum_steps = accum_steps
        self.precision = precision

    def _ident_scale(self) -> float:
        if not (self.automask_warmup and self.loss_mode == "min"):
            return 1.0
        # ramp the identity term from unreachable (1e4x) to exact
        ramp = min(max(self.state.step / self.automask_warmup, 0.0), 1.0)
        return 10.0 ** (4.0 * (1.0 - ramp))

    def loss_fn(self, batch: Dict[str, torch.Tensor]):
        """(loss, reproj, smooth, extra) of one normalized (micro-)batch."""
        state = self.state
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=self.precision == "bf16"):
            disps_tgt, disps_ref0, poses = forward_batch(
                state.depth_model, state.pose_model, batch, train=True
            )
        disps_tgt = [d.float() for d in disps_tgt]
        disps_ref0 = [d.float() for d in disps_ref0]
        reproj, smooth = total_loss(
            batch["tgt"], [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]],
            [disps_tgt, disps_ref0], poses.float(), batch["intrinsics"],
            mode=self.loss_mode, smooth_weight=self.smooth_weight,
            smooth_on=self.smooth_on, depth_norm=self.depth_norm,
            ident_scale=self._ident_scale(), no_ssim=self.no_ssim,
            min_bidirectional=self.min_bidirectional,
        )
        loss = reproj + smooth
        extra = {}
        if self.supervised_weight and "groundtruth" in batch:
            # masked L1 in meters on the finest-scale depth; gt == 0 means
            # no LiDAR return
            gt = batch["groundtruth"]
            pred = disp_to_depth(disps_tgt[0][:, 0])
            valid = (gt > 1e-3).float()
            sup = torch.sum(torch.abs(pred - gt) * valid) / torch.clamp(
                valid.sum(), min=1.0
            )
            loss = loss + self.supervised_weight * sup
            extra["supervised_loss"] = sup
        return loss, reproj, smooth, extra

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        state = self.state
        batch = normalize_uint8_batch(batch_to_device(
            batch, self.device, keep_groundtruth=bool(self.supervised_weight)
        ))
        if batch["tgt"].shape[0] % self.accum_steps:
            raise ValueError("the batch size must be a multiple of accum_steps")
        state.optimizer.zero_grad(set_to_none=True)
        # micro-batch i is rows [i·mb, (i+1)·mb), the JAX reshape's order
        chunks = {k: v.chunk(self.accum_steps) for k, v in batch.items()}
        sums: Dict[str, torch.Tensor] = {}
        for i in range(self.accum_steps):
            micro = {k: v[i] for k, v in chunks.items()}
            loss, reproj, smooth, extra = self.loss_fn(micro)
            loss.backward()
            values = {"loss": loss, "mul_app_loss": reproj,
                      "smoothness_loss": smooth, **extra}
            for k, v in values.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        scale = 1.0 / self.accum_steps
        if self.accum_steps > 1:
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.mul_(scale)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {k: v * scale for k, v in sums.items()}


def make_train_step(state: TrainState, device: str | torch.device = "cuda",
                    **step_kwargs) -> TrainStep:
    """Build the train step over `state` (see TrainStep for step_kwargs)."""
    return TrainStep(state, device=device, **step_kwargs)


# --------------------------------------------------------------------------
# validation
# --------------------------------------------------------------------------


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
        _check_precision(precision)
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
                self.depth_model, self.pose_model, batch, train=False
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


# --------------------------------------------------------------------------
# the epoch loop
# --------------------------------------------------------------------------


class Trainer:
    """Config -> models, optimizer, train and eval steps, epoch loop.

    The JAX Trainer without checkpoints, wandb or a mesh: from_scratch
    False (resume) raises until checkpoints are ported. Weights come from
    a torch.Generator seeded with action.random_seed."""

    def __init__(
        self,
        config: Config,
        dataset=None,
        log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
        device: str | torch.device = "cuda",
    ):
        act = config.action
        if not act.from_scratch:
            raise NotImplementedError(
                "from_scratch: False (resume from a checkpoint) is not ported yet"
            )
        self.config = config
        self.device = resolve_device(device)
        self.log_fn = log_fn
        self.steps_per_epoch = (
            max(1, len(dataset) // act.batch_size) if dataset is not None else 1000
        )
        generator = torch.Generator().manual_seed(act.random_seed)
        self.state = create_train_state(config, generator, self.steps_per_epoch,
                                        self.device)
        aug = config.datasets.augmentation
        self.train_step = make_train_step(
            self.state, device=self.device, loss_mode=act.loss_mode,
            semi_sup_pose=act.semi_sup_pose, smooth_weight=act.smooth_weight,
            smooth_on=act.smooth_on, depth_norm=act.depth_norm,
            automask_warmup=act.automask_warmup, no_ssim=act.no_ssim,
            min_bidirectional=act.min_bidirectional,
            supervised_weight=act.supervised_weight,
            accum_steps=act.accum_steps, remat=act.remat,
            color_jitter=aug.color_jitter, hflip=aug.hflip,
            precision=act.precision,
        )
        self.eval_step = make_eval_step(
            self.state.depth_model, self.state.pose_model,
            loss_mode=act.loss_mode, depth_norm=act.depth_norm,
            precision=act.precision, device=self.device,
        )

    def run_epoch(self, train_batches) -> Dict[str, float]:
        """One pass over an iterable of host batches -> the last step's
        metrics as floats (read from the device once, at the end)."""
        metrics = None
        for i, batch in enumerate(train_batches):
            metrics = self.train_step(batch)
            if self.log_fn is not None and (i + 1) % self.config.action.log_freq == 0:
                self.log_fn({k: float(v) for k, v in metrics.items()},
                            self.state.step)
        if metrics is None:  # empty iterator
            return {}
        return {k: float(v) for k, v in metrics.items()}

    def validate(self, val_batches) -> Dict[str, float]:
        """Mean of the eval step's metrics over an iterable of batches."""
        sums: Dict[str, List[torch.Tensor]] = {}
        count = 0
        for batch in val_batches:
            metrics, _ = self.eval_step(batch)
            for k, v in metrics.items():
                sums.setdefault(k, []).append(v)
            count += 1
        return {k: float(torch.stack(v).sum() / max(count, 1))
                for k, v in sums.items()}
