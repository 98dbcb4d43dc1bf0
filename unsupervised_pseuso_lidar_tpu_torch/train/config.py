"""Typed, validated configuration (YAML -> dataclasses).

Counterpart of unsupervised_pseuso_lidar_tpu/train/config.py, kept as a
copy so the port never imports the JAX package: the same schema, defaults
and validation, so every file under configs/ loads unchanged. Keys that
only tune the TPU build (warp_impl, warp_col_band, remat) are parsed and
ignored by the port — its warp is the one exact kernel whatever warp_impl
says.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

import yaml


@dataclass
class ModelHead:
    name: str = "DispResNet"
    kwargs: Dict[str, Any] = field(default_factory=dict)
    # Path to a pretrained torch init (.pth or .npz): a torchvision
    # resnet18 ImageNet state dict (encoder-only, the reference's
    # ResnetEncoder(18, pretrained=True) setup), a DispResNet state dict,
    # or a full reference checkpoint. '' = random init.
    pretrained_path: str = ""


@dataclass
class ModelConfig:
    name: str = "model"
    depth: ModelHead = field(default_factory=lambda: ModelHead("DispResNet"))
    pose: ModelHead = field(default_factory=lambda: ModelHead("PoseNet"))


@dataclass
class AugmentationConfig:
    image_width: int = 640
    image_height: int = 192
    shuffle: bool = True
    color_jitter: bool = False
    hflip: bool = False


@dataclass
class DatasetConfig:
    path: str = ""
    split: str = ""
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    sequence_length: int = 3
    dataset: List[str] = field(default_factory=lambda: ["KITTI"])
    cache_dir: str = ""  # decoded-uint8 image cache ('' = decode every epoch)
    # rasterize sparse GT depth from velodyne_points/*.bin scans when a
    # split line has no annotated-depth path — lets any raw KITTI drive
    # yield eval metrics without the data_depth_annotated archive
    velo_gt: bool = False


@dataclass
class OptimizerConfig:
    name: str = "Adam"
    depth_lr: float = 1e-4
    pose_lr: float = 1e-4


@dataclass
class SchedulerConfig:
    name: str = "StepLR"
    step_size: int = 30  # epochs between decays (torch StepLR semantics)
    gamma: float = 0.1


@dataclass
class ActionConfig:
    mode: str = "train"
    mlops: bool = False
    log_freq: int = 100
    from_scratch: bool = True
    split: List[float] = field(default_factory=lambda: [0.8, 0.2])
    random_seed: int = 42
    batch_size: int = 4
    num_epochs: int = 30
    num_workers: int = 8
    # 'thread' | 'process': process workers keep every host core decoding
    # (the OXTS parse and the collation hold the GIL; see data/kitti.batches)
    worker_type: str = "thread"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    semi_sup_pose: bool = False
    eval_median_scale: bool = False
    # 'none' | 'eigen': 'eigen' applies the standard KITTI Eigen-split
    # monocular protocol (Garg crop + [1e-3, 80] m caps + per-image median
    # scaling) — the setting for parity runs against published numbers
    eval_protocol: str = "none"
    # also report pose metrics (snippet ATE + rotation error vs the
    # split's OXTS odometry, eval/pose.py) during per-epoch validation
    eval_pose: bool = False
    loss_mode: str = "mean"
    # loss_mode 'min' only: ramp the automask identity term from
    # unreachable down to exact over this many steps (0 = off = exact
    # monodepth2 automask from step 0). Early full-image photometric
    # supervision lets static/occluded regions learn depth before the
    # automask starts excluding them (benchmarks/REPORT.json occlusion_*
    # rows; train/trainer.make_train_step_body).
    automask_warmup: int = 0
    # loss_mode 'min' only: drop the SSIM blend from the photometric error
    # (pure L1, the reference's active error model). SSIM's windowed
    # statistics can slow early convergence on clean/low-noise imagery.
    no_ssim: bool = False
    # loss_mode 'min' only: add the reference's backward direction (warp
    # tgt into ref0's frame with ref0's depth) so the second depth forward
    # supervises a second viewpoint per step (losses/reprojection.py).
    min_bidirectional: bool = True
    smooth_weight: float = 1.0
    smooth_on: str = "depth"  # 'depth' = reference parity; 'disp' = monodepth2
    # per-image mean-normalize depth before warping (losses/total.py
    # _mean_normalize) — kills the uniform-scale (shrinking-depth) runaway;
    # off = reference parity, on in the production objective conditioning
    depth_norm: bool = False
    # optional sparse-LiDAR depth supervision (masked L1, meters) added
    # to the self-supervised objective; 0 = off (reference behavior —
    # its loss receives gt but never uses it, losses.py:262-271)
    supervised_weight: float = 0.0
    warp_impl: str = "mxu"  # 'mxu' = band-matmul warp (fast); 'gather' = exact
    # fused-Pallas-warp column-window width (0 = auto: 384 on lane-aligned
    # widths >= 512). Must be a positive multiple of 128 when set; narrower
    # = fewer warp FLOPs, less horizontal-flow coverage (col_coverage
    # metric guards). Only warp_impl='pallas' consumes it.
    warp_col_band: int = 0
    precision: str = "fp32"  # 'fp32' | 'bf16' (bf16 model compute, fp32 params/loss)
    accum_steps: int = 1
    remat: bool = False
    checkpoint_dir: str = "./pretrained"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    datasets: DatasetConfig = field(default_factory=DatasetConfig)
    action: ActionConfig = field(default_factory=ActionConfig)

    @property
    def image_shape(self):
        aug = self.datasets.augmentation
        return (aug.image_height, aug.image_width)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        model_raw = dict(raw.get("model", {}))
        depth_raw = dict(model_raw.get("depth", {}) or {})
        pose_raw = dict(model_raw.get("pose", {}) or {})
        for legacy in ("file", "version"):
            depth_raw.pop(legacy, None)
            pose_raw.pop(legacy, None)
        model = ModelConfig(
            name=model_raw.get("name", "model"),
            depth=ModelHead(
                name=depth_raw.pop("name", "DispResNet"),
                pretrained_path=depth_raw.pop("pretrained_path", ""),
                kwargs=depth_raw,
            ),
            pose=ModelHead(
                name=pose_raw.pop("name", "PoseNet"),
                pretrained_path=pose_raw.pop("pretrained_path", ""),
                kwargs=pose_raw,
            ),
        )

        ds_raw = dict(raw.get("datasets", {}))
        aug_raw = dict(ds_raw.get("augmentation", {}) or {})
        datasets = DatasetConfig(
            path=ds_raw.get("path", ""),
            split=ds_raw.get("split", ""),
            augmentation=AugmentationConfig(
                image_width=int(aug_raw.get("image_width", 640)),
                image_height=int(aug_raw.get("image_height", 192)),
                shuffle=bool(aug_raw.get("shuffle", True)),
                color_jitter=bool(aug_raw.get("color_jitter", False)),
                hflip=bool(aug_raw.get("hflip", False)),
            ),
            sequence_length=int(ds_raw.get("sequence_length", 3)),
            dataset=list(ds_raw.get("dataset", ["KITTI"])),
            cache_dir=ds_raw.get("cache_dir", ""),
            velo_gt=bool(ds_raw.get("velo_gt", False)),
        )

        act_raw = dict(raw.get("action", {}))
        opt_raw = dict(act_raw.get("optimizer", {}) or {})
        sched_raw = dict(act_raw.get("scheduler", {}) or {})
        action = ActionConfig(
            mode=act_raw.get("mode", "train"),
            mlops=bool(act_raw.get("MLOps", act_raw.get("mlops", False))),
            log_freq=int(act_raw.get("log_freq", 100)),
            from_scratch=bool(act_raw.get("from_scratch", True)),
            split=list(act_raw.get("split", [0.8, 0.2])),
            random_seed=int(act_raw.get("random_seed", 42)),
            batch_size=int(act_raw.get("batch_size", 4)),
            num_epochs=int(act_raw.get("num_epochs", 30)),
            num_workers=int(act_raw.get("num_workers", 8)),
            worker_type=act_raw.get("worker_type", "thread"),
            optimizer=OptimizerConfig(
                name=opt_raw.get("name", "Adam"),
                depth_lr=float((opt_raw.get("depth") or {}).get("lr", 1e-4)),
                pose_lr=float((opt_raw.get("pose") or {}).get("lr", 1e-4)),
            ),
            scheduler=SchedulerConfig(
                name=sched_raw.get("name", "StepLR"),
                step_size=int(sched_raw.get("step_size", 30)),
                gamma=float(sched_raw.get("gamma", 0.1)),
            ),
            semi_sup_pose=bool(act_raw.get("semi_sup_pose", False)),
            eval_median_scale=bool(act_raw.get("eval_median_scale", False)),
            eval_protocol=act_raw.get("eval_protocol", "none"),
            eval_pose=bool(act_raw.get("eval_pose", False)),
            loss_mode=act_raw.get("loss_mode", "mean"),
            automask_warmup=int(act_raw.get("automask_warmup", 0)),
            no_ssim=bool(act_raw.get("no_ssim", False)),
            min_bidirectional=bool(act_raw.get("min_bidirectional", True)),
            smooth_weight=float(act_raw.get("smooth_weight", 1.0)),
            smooth_on=act_raw.get("smooth_on", "depth"),
            depth_norm=bool(act_raw.get("depth_norm", False)),
            supervised_weight=float(act_raw.get("supervised_weight", 0.0)),
            warp_impl=act_raw.get("warp_impl", "mxu"),
            warp_col_band=int(act_raw.get("warp_col_band", 0)),
            precision=act_raw.get("precision", "fp32"),
            accum_steps=int(act_raw.get("accum_steps", 1)),
            remat=bool(act_raw.get("remat", False)),
            checkpoint_dir=act_raw.get("checkpoint_dir", "./pretrained"),
        )
        config = cls(model=model, datasets=datasets, action=action)
        config.validate()
        return config

    def validate(self) -> None:
        if self.action.batch_size <= 0:
            raise ValueError("action.batch_size must be positive")
        if self.action.num_epochs < 0:
            raise ValueError("action.num_epochs must be >= 0")
        if self.datasets.sequence_length != 3:
            raise ValueError(
                "Only sequence_length=3 (tgt + 2 refs) is supported, like the "
                "reference (configs/basic_config.yaml:17)"
            )
        if len(self.action.split) != 2:
            raise ValueError(
                "action.split must be [train_ratio, val_ratio] "
                f"(got {self.action.split!r})"
            )
        if not (0 <= self.action.split[1] <= 1):
            raise ValueError("validation split ratio must be in [0, 1]")
        if abs(sum(self.action.split) - 1.0) > 1e-6:
            raise ValueError(
                f"action.split ratios must sum to 1 (got {self.action.split!r})"
            )
        if self.datasets.augmentation.hflip and self.action.semi_sup_pose:
            raise ValueError(
                "augmentation.hflip cannot be combined with "
                "action.semi_sup_pose: flipping mirrors the images and "
                "intrinsics but the ground-truth OXTS poses are not "
                "flippable (data/augment.py docstring) — the warp would "
                "use a wrong-signed pose for flipped samples"
            )
        if self.action.precision not in ("fp32", "bf16"):
            raise ValueError("action.precision must be 'fp32' or 'bf16'")
        if self.action.warp_impl not in ("mxu", "gather", "pallas"):
            raise ValueError(
                "action.warp_impl must be 'mxu', 'gather', or 'pallas'"
            )
        if self.action.warp_col_band and (
            self.action.warp_col_band < 0
            or self.action.warp_col_band % 128 != 0
        ):
            raise ValueError(
                "action.warp_col_band must be 0 (auto) or a positive "
                f"multiple of 128, got {self.action.warp_col_band}"
            )
        if self.action.eval_protocol not in ("none", "eigen"):
            raise ValueError("action.eval_protocol must be 'none' or 'eigen'")
        if self.action.worker_type not in ("thread", "process"):
            raise ValueError("action.worker_type must be 'thread' or 'process'")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_config(path: str) -> Config:
    """Load a YAML config (reference schema compatible)."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return Config.from_dict(raw or {})
