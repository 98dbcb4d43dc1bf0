"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --spatial-repeat WORLD RUNS   # one spatial group, RUNS times
    python3 chip_smoke.py --models                      # the kernels' build and the models phase

Builds the port's CUDA kernels from the sources in this checkout (into
build/torch_ext/), holds the division helper of kernels B and C
(ops/cuda/div3.cuh) against the IEEE division over all 2^32 fp32 bit
patterns, holds each kernel against its plain PyTorch version at
the shapes of the production configuration (configs/tpu_v5e.yaml:
DispResNet-18 + PoseNet, 640x192, batch 12, bf16 models, fp32 loss),
then drives the port's entry points with seeded random weights:

  serve         DepthToPointCloudPipeline.run over 20 synthetic frames (the
                pipeline's depth -> cloud program a CUDA graph: a warm-up
                frame runs eagerly, the first of the 20 captures, the rest
                replay)
  validation    3 steps of the eval step (make_eval_step), whose photometric
                objective launches kernel A once and kernel B twice a step
  train         Trainer.run_epoch over 3 steps (after 2 warm-up steps: the
                eager first call of the batch shape, then the capture), each
                launching A and its grid gradient A' once, B twice and the
                SSIM backward C once
  train_basic   the training CLI (cli/train.py main) on configs/basic_config.yaml
                (DispResNet-18 + PoseFc, 1280x384, batch 4, fp32, 'min'):
                2 epochs of 3 synthetic batches, a checkpoint each; then a
                fresh Trainer resumes from it (from_scratch False, bit-exact
                restore) and takes 3 timed steps
  kernels_1280  A, A', B and C against their plain versions on the shapes
                of train_basic, timed
  eval_metrics  Trainer.validate over 3 synthetic batches at basic_config's
                size with the Eigen protocol and pose metrics; the metrics
                on the card vs the same tensors on the CPU
  train_mean    configs/synthetic.yaml (DispResNet-18 + PoseNet, 640x192,
                batch 12, the 'mean' objective: one stacked warp, no SSIM)
                for 3 steps, then one step of the 'ssim' objective
  kitti         a KITTI-shaped drive written to a temp dir (26 RGB frames of
                1242x375 PNG, OXTS, velodyne scans of 120,000 points,
                16-bit annotated depth PNGs); through the port's own CLIs:
                cli.splits (annotated, drive), cli.train on basic_config
                with color jitter and flips (1 epoch, 8 thread workers;
                launches per step and per validation batch), one
                semi_sup_pose step (the pose net unchanged), the loss-side
                gradients of an augmented batch card vs CPU, cli.evaluate
                (eigen + pose metrics; velodyne ground truth) card vs
                --device cpu, the velodyne rasterizer card vs CPU,
                cli.odometry with its ground-truth file (its trajectory
                equal to an eager run's, on the whole drive and on 22
                windows, the last batch padded); and the
                steady-state ms a training step over two more passes of
                the drive (the loader's first fill apart), the loader's ms
                a batch (decode cache cold and warm) and the loop's wait
                for batches
  serve_cli     the serving CLIs on the kitti phase's drive, configs/tpu_v5e.yaml
                (640x192, bf16) with the seeded weights written as a reference
                .pth: cli.pipeline with one camera (unpaced, lossless queue,
                .bin clouds, read back and one frame held to the in-process
                pipeline) and with two (the drive twice), frames/s of each;
                the latency a frame at the reference's 10 Hz (FileImageSource
                + run, latest-wins queue), from the source yielding a frame
                to its result, after two unpaced warm-up frames (the eager
                first call, the capture; their ms apart as `warmup_ms`); cli.export of configs/basic_config.yaml
                (1280x384) fused with the projector, batch-polymorphic, with
                --verify, then run_exported at batch 1 and 2 against the live
                module; cli.inference with a .bin cloud. A, A', B and C are
                launched no time: the serving path holds no kernel of ops/cuda.
                cli.pipeline and the in-process pipeline replay CUDA graphs;
                cli.inference and cli.export run eagerly
  serve_graph   serving as one program: DepthToPointCloudPipeline captured
                (the default on the card) against graph=False on the same
                seeded weights and the kitti drive's frames, cuDNN
                deterministic, for tpu_v5e (DispResNet-18, bf16, 640x192,
                batch 1), basic_config (fp32, 1280x384, batch 1, and a
                2-camera rig through process_batch) and BtsModel (512
                features, fp32, 352x1216, its metric depth): depth, points
                and valid compared uncompacted (0.0 expected), ms a frame
                over 20 frames after the warm-up and capture by the host
                clock and CUDA events, op_breakdown's busy share over 3
                calls, graph launches a frame, capture seconds, the graph
                pool's bytes beside the eager pipeline's peak; then the
                pose-only eval step (make_pose_eval_step) captured against
                eager on the drive's batches, every metric equal
  profile       torch.profiler on the card (utils/trace.op_breakdown): the
                device time of a training step by op family, 3 steps after 2
                of warm-up, on basic_config (TF32 off as everywhere here, then
                with cuDNN's TF32 on as a user's cli.train leaves it) and on
                tpu_v5e: the top families, the device ms and the host window
                a step, the device's busy share, and each kernel's in-step ms
                and launches as the profiler counts them (equal to the
                wrappers' counts); cli.train --op-breakdown --profile on the
                kitti drive (the KITTI step's device ms beside kitti's
                steady ms a step; the fit's trace holds the four kernels as
                often as their wrappers launched them); Trainer.log_warps on
                a basic_config batch (three PNGs, one launch of A)
  models        the rest of the model zoo. BtsModel (DenseNet-161 + ASPP + LPG),
                the reference ROS node's model, at its 352x1216, batch 1, fp32,
                seeded weights, on the kitti drive's frames: cli.export
                --format bts-serving writes the ROS blob, cli.pipeline
                serves it (frames/s; latency at 10 Hz), one frame held to the
                in-process make_depth_cloud_fn(make_depth_fn(bts,
                metric_output=True)), cli.export fused with the projector
                (--verify; run_exported vs the live module), the forward card
                vs CPU, peak memory, and no launch of A, A', B or C. Then
                basic_config's training (1280x384, batch 4, fp32, 'min',
                PoseFc) with its depth net replaced by DispNetS (4 scales),
                StnDispNet with its spatial transformer (1 scale) and
                DispResNet-50 with all_scales (4 scales): 3 timed steps each,
                launches {S, S, S + 1, S} a step for S scales, finite losses,
                peak memory, loss gradients card vs CPU; and PoseDecoder over
                ResNet-50 encoder features, card vs CPU. Then `determinism`:
                the same three nets and BtsModel (352x1216, batch 1), each
                two eager steps from one state under cuDNN deterministic,
                every gradient leaf, the loss and the BatchNorm statistics
                required equal bit for bit, and the ops that
                torch.use_deterministic_algorithms(True, warn_only=True)
                names in a third step; resize_bilinear's gradient at the
                loss's shapes ([4, 1, 384/2^s, 1280/2^s] -> 384x1280, s =
                1..3) and resize_nearest's at BtsModel's, twice on the card
                and once on the CPU, required equal bit for bit, timed
                beside torch's own upsample_bilinear2d_backward (itself
                taken twice)
  parallel      data parallelism (parallel/, the step under a mesh). World
                size 1 under NCCL, in this process: basic_config's Trainer
                under make_mesh(1) against the plain Trainer from the same
                seed for 3 steps (the parameter gradients at rel L2 <= 1e-4:
                only the synced BatchNorm's formula differs; each step from
                the plain trainer's state). Then 2 gloo
                ranks spawned on the one card, each on its half of the
                batch: basic_config (batch 4 -> 2 + 2) for 3 steps against
                the one-process step on the whole batch (the loss, the
                all-reduced gradient and the BatchNorm statistics after
                step 1, the parameters after step 3), then
                configs/synthetic.yaml's 'mean' (batch 12 -> 6 + 6) and
                'ssim' for a step each; A, A', B and C launched on every
                rank. Each rank's ms a step is two ranks sharing ONE card,
                not a scale-out figure. cli.train --mesh 1 trains as
                before; --mesh 2 on a one-card machine raises with the count
  spatial       the "spatial" mesh axis (image rows sharded over ranks in
                bands of the 32-row grain: halo-exchanging convolutions, the
                loss on bands, kernels A and A' on a band of grid rows). gloo
                ranks spawned on the one card, four groups: at data 1 x
                spatial 2 basic_config (1280x384, batch 4, 'min', PoseFc,
                depth_norm; each rank 192 rows) for 2 steps, the same with
                action.remat (against the ranks' remat-off steps too), and
                with DispResNet-18 all_scales for 2 (launches {4, 4, 5, 4}),
                then Trainer.fit of basic_config for an epoch of 2 batches
                with a wandb stub on rank 0 (rank 0's log_warps pictures
                against a Trainer without the mesh); configs/synthetic.yaml's
                'ssim' at data 2 x spatial 2 (640x192, batch 12; each rank 6
                images of 96 rows) for two; configs/tpu_v5e.yaml at data 1 x
                spatial 4 (640x192, batch 12; bands of 64, 64, 32, 32 rows)
                for 2 steps in fp32 (the config's precision overridden),
                then one at its own bf16 (the loss beside the one-process
                bf16 step's). In the first group also basic_config with
                DispNetS (4 scales; its 128x level on the gathered map,
                launches {4, 4, 5, 4}) and with StnDispNet and its STN
                (GroupNorm over the bands, banded transposed convs, the
                whole frame sampled) for 2 steps each; and configs/tpu_v5e.yaml
                at data 1 x spatial 8 in fp32 (JAX's equal bands of 24
                rows, which hold no row of layer3 / layer4: those levels
                gathered) for 2. BtsModel (num_features 512) + PoseNet at
                the reference ROS node's 352x1216 with basic_config's
                objective for 2 steps: at data 1 x spatial 2 (batch 4;
                bands of 192 / 160 rows, the ASPP's 24-row halos at 1/8
                reaching past the 20-row band) and at data 1 x spatial 4
                (batch 2; 96 / 96 / 96 / 64: the halos cross one or two
                bands); launches {5, 5, 6, 5} (its five full-resolution
                outputs are five scales of the loss). The non-integer
                resamples of a band (the coarse map gathered, resized whole
                and cut back), 2 steps each at data 1 x spatial 2 with
                basic_config's objective: DispResNet-18 all_scales and
                DispNetS at 188x640 (13 rows of 1/8 to 188: 188 is no
                multiple of 8) and StnDispNet without its STN at 184x640
                (its decoder's 192 rows resized to 184). The basic_config
                cases run 2 steps (3 before BtsModel joined the phase).
                Each step starts from the one-process
                trainer's state before that step; against its step on the
                whole batch: the loss, the gradient, the BatchNorm
                statistics, and each rank's launches of A, A', B and C; each
                rank's ms a step, peak memory (allocated, reserved, and the
                card's free memory after the step) and the memory its
                autograd graph holds at the loss beside the one process's
                (ranks time-sharing one card)

  graph         the step as one program: TrainStep, make_multi_step and
                EvalStep captured as CUDA graphs (train/graph.py; on by
                default on the card without a mesh, so every phase above and
                below that trains or validates without a mesh runs them).
                On tpu_v5e (640x192, batch 12, bf16) and basic_config
                (1280x384, batch 4, fp32), with cuDNN deterministic: the
                captured Trainer against one with graph=False from the
                same seed, a warm-up step each, then 3 steps (the first
                captures, the others replay): the first step's loss and
                parameter gradients equal, the later losses and the
                parameters, Adam moments and BatchNorm statistics after
                the third at rel L2 <= 1e-6; a returned metrics dict not
                overwritten by the next step; the eval step (Eigen
                protocol, pose metrics) captured against eager on the same
                modules, metrics and depth_pred equal. Then per config,
                and basic_config with cuDNN's TF32 on: the captured and
                the eager step's host ms a step, CUDA-event ms a step,
                op_breakdown's device ms, host window and busy share
                over 3 steps, graph launches a step, capture seconds, the
                graph pool's bytes and each path's peak memory. Then
                make_multi_step(num_steps=3) on tpu_v5e: one replay makes
                3 updates, its state equal to 3 captured single steps',
                and the times of one replay against 3 single replays

  mesh_graph    the step captured under an NCCL mesh: world 1 under NCCL in
                this process (make_mesh(1)), basic_config (1280x384, batch 4,
                fp32, 'min', PoseFc), cuDNN deterministic: the Trainer's
                train step captured (graph=None, the default under NCCL)
                against graph=False from the same seed for 4 steps,
                make_multi_step(2) for 3 calls and the mesh's eval step
                (Eigen protocol, pose metrics) over 3 batches: every
                metric, the parameters, gradients, BatchNorm statistics and
                Adam moments equal bit for bit (the first differing key is
                printed); the launches of A, A', B and C a replay
                ({1, 1, 2, 1} a step), the all-reduces captured a step
                (counted at the capture), capture seconds, the graph pools'
                bytes; then the captured and the eager step's host ms and
                CUDA-event ms a step and busy share. The world-1 check of
                `parallel` runs captured too; its gloo ranks, and the
                spatial phase's, stay eager (graph=None under gloo)
  examples      the JAX package's examples on the port
                (unsupervised_pseuso_lidar_tpu_torch/examples/): the toy
                problem at its script's size (64x96, batch 4, ground-truth
                poses, 'mean'), 200 captured steps with cuDNN
                deterministic: its depth error list (which falls, then
                collapses to 90 m as the JAX script's does; the script's
                verdict printed), the same 200 steps captured and eager
                through the module's seams equal bit for bit (every loss,
                the depth errors, parameters, buffers, Adam's moments), the
                first step's error card vs CPU, A and A' launched once a
                step (B and C never), and its ms a step over 20 more; then
                the dinosaur turntable at its script's size (192x256, batch
                8, 400 steps) on a synthetic stand-in tree written to a temp
                dir by tests/torch_turntable_fixture.py (36 frames of
                720x576 .ppm, dino_Ps.mat of cameras 10° apart round the
                turntable's axis, a textured plane behind it): the
                warp_err trajectory finite, the ground-truth pose's warp at
                init better than the identity warp; then a data root that
                does not exist, skipped with the script's message

The kernel phases time each kernel, its plain version and the library
call (where one exists) on the card: CUDA events around 20 back-to-back
calls, divided by 20, the median of 5 such runs (`ms`);
`ms_per_call_host_incl` is the older measure, events around one call,
which also counts the host's work before the launch.

The kernels record gains each kernel's in-step device ms and launches
from the profile phase (`profiled_ms_per_step`, `profiled_launches`).

Every phase prints one JSON line; every check that fails raises, and the
script exits non-zero. Before the last line it prints the per-kernel
record ({"kernels": [...]}, each kernel at both shape sets) and the
card's name and power limit as nvidia-smi reports them; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the rest of the repository beside it,
it exits non-zero and prints no result.
"""

import contextlib
import gc
import importlib.util
import io
import itertools
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
import types
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
import yaml
from PIL import Image

from unsupervised_pseuso_lidar_tpu_torch.cli import evaluate as eval_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import export as export_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import inference as inference_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import odometry as odometry_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import pipeline as pipeline_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import splits as splits_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import train as train_cli
from unsupervised_pseuso_lidar_tpu_torch.data.augment import augment_batch, draw_params
from unsupervised_pseuso_lidar_tpu_torch.data.kitti import UnSupKittiDataset
from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import (
    SyntheticTripletDataset,
    synthetic_triplet_batch,
)
from unsupervised_pseuso_lidar_tpu_torch.eval.metrics import METRICS, eigen_crop_mask
from unsupervised_pseuso_lidar_tpu_torch.eval.pose import make_pose_eval_step
from unsupervised_pseuso_lidar_tpu_torch.eval.trajectory import kitti_odometry_lines
from unsupervised_pseuso_lidar_tpu_torch.examples import dino_turntable, toy_problem
from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.geometry.oxts import (
    load_oxts_packets_and_poses,
    load_velo_scan,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import (
    invert_pose,
    pose_matrix,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    disp_to_depth,
    warp_coords,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.total import normalize_depth, total_loss
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import build, kernels
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import (
    grid_sample,
    grid_sample_grad_grid,
    resize_bilinear,
    resize_bilinear_grad,
    resize_nearest,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import (
    photometric_map,
    photometric_map_bwd,
)
from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import make_mesh, row_bands
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import (
    load_exported,
    make_depth_cloud_fn,
    make_depth_fn,
    run_exported,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
    DepthToPointCloudPipeline,
    FileImageSource,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
    PseudoLiDAR,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.velo2img import (
    project_velo_to_depth_image,
)
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
    export_reference_checkpoint,
    load_serving_weights,
)
from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    Trainer,
    batch_to_device,
    create_train_state,
    depth_scales,
    forward_batch,
    make_eval_step,
    make_multi_step,
    normalize_uint8_batch,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.device import card, device_time_ms
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import div
from unsupervised_pseuso_lidar_tpu_torch.utils.trace import (
    newest_trace,
    op_breakdown,
    summarize_trace,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import (
    normalize_image,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "tpu_v5e.yaml")
BASIC_CONFIG = os.path.join(ROOT, "configs", "basic_config.yaml")
MEAN_CONFIG = os.path.join(ROOT, "configs", "synthetic.yaml")
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and fp32
# (non-tensor-core) rate — both kernels are fp32 elementwise/stencil work
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# per-pixel operation counts of the kernels (coordinates, floors, weights
# and 3 channels x 4 taps for A; 5 moment sums, products, SSIM ratio,
# clamp and blend for B)
WARP_OPS_PER_PIXEL = 45
SSIM_OPS_PER_PIXEL = 62
# A': coordinates and weights, then per channel 4 tap differences, 4
# products, 2 sums and the contraction with g, and the two scales; C: the
# five moments from 9 taps (27 products, 15 row and 5 column means), the
# SSIM terms and g_a..g_d (4 divisions), two plane products, the W and H
# adjoints of 4 planes, and the output combination with the L1 term
WARP_BWD_OPS_PER_PIXEL = 65
SSIM_BWD_OPS_PER_PIXEL = 200
WARP_TOL = 1e-5
SSIM_TOL = 2e-5
# the backward kernels vs their plain versions, relative to the largest
# gradient entry (dx of the SSIM grows as 1/(c·d) in flat windows)
BWD_RTOL = 1e-5
LIBRARY_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-4
# the evaluation metrics on the card vs the same tensors on the CPU
METRIC_RTOL = 1e-5
TRAIN_STEPS = 3
# train_basic: epochs x synthetic batches an epoch through the CLI
BASIC_EPOCHS = 2
BASIC_BATCHES = 3
# pseudo-LiDAR on the card vs the CPU: points in meters (fp32, depths up
# to 100 m), and the share of pixels whose crop decision may flip at the
# crop's edges through rounding
POINTS_ATOL = 1e-3
POINTS_MASK_MISMATCH = 1e-3
# kitti: KITTI's frame size (height, width), frames in the drive, points
# a velodyne scan, thread workers of the loader, and the velodyne raster
# card vs CPU (the same fp32 operations in the same order: values at rel
# 1e-6, pixels set may differ only where a coordinate rounds across an edge)
KITTI_FRAME = (375, 1242)
KITTI_FRAMES = 26
KITTI_POINTS = 120_000
KITTI_WORKERS = 8
VELO_RTOL = 1e-6
# serve_cli: the reference pipeline's replay rate; a CLI's cloud and depth
# against the in-process pipeline's on the same device and program; an
# exported program against its live module (cli.export --verify's bound)
SERVE_RATE_HZ = 10.0
# the models phase: BtsModel at the reference ROS node's frame size (H, W);
# its five outputs card vs CPU (relative L2, TF32 off)
BTS_SHAPE = (352, 1216)
# the spatial phase's BtsModel cases: BtsModel (JAX's width) + PoseNet at
# the ROS node's size with basic_config's objective (spatial_setup's
# overrides)
BTS_CASE = {"depth": ("BtsModel", {"num_features": 512}), "pose": ("PoseNet", {}),
            "image_shape": BTS_SHAPE}
BTS_REL_L2 = 1e-5
# the depth nets trained at basic_config's shape: (name, kwargs, output
# scales)
ZOO_TRAIN = (("DispNetS", {}, 4), ("StnDispNet", {"use_stn": True}, 1),
             ("DispResNet", {"num_layers": 50, "all_scales": True}, 4))
# the models phase's determinism cases: spatial_setup's overrides of
# basic_config (BtsModel at batch 1: its eager step at 352x1216 holds tens
# of GiB at larger batches)
DETERMINISM_CASES = (("DispNetS", {"depth": ("DispNetS", {})}),
                     ("StnDispNet-stn", {"depth": ("StnDispNet", {"use_stn": True})}),
                     ("DispResNet-50", {"depth": ("DispResNet",
                                                  {"num_layers": 50, "all_scales": True})}),
                     ("BtsModel", {**BTS_CASE, "batch_size": 1}))
# the loss's upsamples of a coarse scale s to basic_config's 384x1280
# (losses/reprojection._full_res_depth), batch 4, and BtsModel's nearest
# downsamples of a full-resolution depth (models/depth/bts._downsampled)
RESIZE_SCALES = (1, 2, 3)
NEAREST_FACTORS = (2, 4)
# PoseDecoder's 0.01-scaled outputs card vs CPU
POSE_DECODER_ATOL = 1e-6
# the zoo's loss gradients card vs CPU on the first rows of a batch only
# (the CPU's plain warp and SSIM over four scales at 1280x384 are slow)
ZOO_GRAD_ROWS = 2
SERVE_RTOL = 1e-6
EXPORT_TOL = 2e-5
# parallel: the gradient of the step under a world-1 NCCL mesh vs the plain
# step (the synced BatchNorm's formula, fp64 sums against F.batch_norm's
# fp32 ones, is the one difference: 1.7e-6 to 4.1e-5 over 3 seeds on an
# H100 80GB HBM3 at 700 W) and of 2 gloo ranks on the card vs the one-process step on
# the whole batch at the card-vs-CPU budget (GRAD_REL_L2); the loss at
# JAX's sharded-vs-single-device tolerance, BatchNorm statistics, and the
# parameters after 3 steps at JAX's test_multi_step_mesh tolerance
PARALLEL_RANKS = 2
PARALLEL_LOSS_RTOL = 2e-4
PARALLEL_STATS_RTOL = 1e-5
PARALLEL_PARAMS_RTOL, PARALLEL_PARAMS_ATOL = 1e-3, 2e-4
PARALLEL_TIMEOUT_S = 300
# what a spawned rank on the shared card keeps outside its allocator's cap
# (its CUDA context and libraries' handles): each rank's cap is an equal
# share of the card's free memory less this (spatial_rank)
RANK_OVERHEAD_BYTES = 2**30
# the spatial phase's sharded step vs the one-process step from the same
# state: the loss (the gradient at GRAD_REL_L2, the BatchNorm statistics
# at PARALLEL_STATS_RTOL)
SPATIAL_LOSS_RTOL = 1e-6
# the spatial cases whose steps also run under a one-rank data mesh
# (BatchNorm summed as on the bands, layers._GlobalBatchNorm): BtsModel's,
# with 160 train-mode BatchNorms. That rounding change of the BatchNorm
# alone moves BtsModel's step 3.2e-5 – 1.22e-4 from the plain step at
# 352x1216 (NVIDIA H100 80GB HBM3, 700 W), so their banded step is held to
# the one-rank mesh (loss at SPATIAL_LOSS_RTOL, gradient at GRAD_REL_L2)
# and the one-rank mesh to the plain step at BN_SUM_GRAD_REL_L2, twice
# the largest of those drifts; the banded step's distance to the plain
# step is recorded
ONE_RANK_BESIDE = ("bts_1x2", "bts_1x4")
BN_SUM_GRAD_REL_L2 = 2.5e-4
# the bf16 step under the mesh vs the one-process bf16 step (bf16
# convolutions on bands round otherwise than on the whole image)
SPATIAL_BF16_LOSS_RTOL = 1e-2
# fit's pictures under the mesh (eval-mode banded forward, then the
# gathered depth) vs a Trainer without the mesh: rel L2
SPATIAL_PICTURE_RTOL = 1e-5
# the real 2011_09_26 IMU -> velodyne transform
PROFILE_STEPS, PROFILE_WARMUP = 3, 2
# the graph phase: steps compared captured vs eager, steps timed by the
# host clock, make_multi_step's K, and the bound of a captured step's
# state against the eager one's (0.0 expected: the same kernels in the
# same order)
GRAPH_STEPS, GRAPH_TIMED_STEPS, GRAPH_MULTI = 3, 10, 3
GRAPH_REL_L2 = 1e-6
# the serve_graph phase: frames (or rig steps) timed after the eager first
# call and the capture; and the kitti phase's cli.odometry cut to a number
# of windows its batch of 4 does not divide (the last batch padded)
SERVE_GRAPH_FRAMES = 20
ODOMETRY_PADDED_WINDOWS = 22
# the examples phase: the toy problem's steps (its script's default) and
# the steps timed apart; the turntable's steps, batch and size (its
# script's defaults)
TOY_STEPS, EXAMPLE_TIMED_STEPS = 200, 20
# the toy's depth error after its first step, card vs CPU (its later steps
# are chaotic: the disparity collapses)
TOY_FIRST_RTOL = 1e-4
DINO_STEPS, DINO_BATCH, DINO_SIZE = 400, 8, (192, 256)
# the mesh_graph phase: train steps captured vs eager (the first eager,
# the second captures, the others replay), make_multi_step's K (3 calls),
# eval batches
MESH_STEPS, MESH_MULTI, MESH_EVAL = 4, 2, 3
# TrainStep's arguments, to build make_multi_step like a Trainer's step
STEP_ARGS = ("loss_mode", "semi_sup_pose", "smooth_weight", "smooth_on", "depth_norm",
             "automask_warmup", "no_ssim", "min_bidirectional", "supervised_weight",
             "accum_steps", "remat", "color_jitter", "hflip", "aug_seed", "precision",
             "with_coverage")
# each kernel's family in the profiler's trace (utils/trace._op_family)
PROFILED_FAMILY = {"warp_bilinear_fwd": "warp_bilinear_fwd_kernel",
                   "warp_bilinear_bwd": "warp_bilinear_bwd_grid_kernel",
                   "ssim_fwd": "ssim_fwd_kernel", "ssim_bwd": "ssim_bwd_kernel"}
# the families of cuDNN's and cuBLAS's convolution and GEMM kernels, the
# FFT convolutions' transforms and the layout conversions around them
CONV_WORDS = ("conv", "fft", "fprop", "dgrad", "wgrad", "xmma", "gemm", "cutlass",
              "pointwise_mult_and_sum_complex", "nchwToNhwc", "nhwcToNchw")
IMU_TO_VELO = ("R: 9.999976e-01 7.553071e-04 -2.035826e-03 -7.854027e-04 "
               "9.998898e-01 -1.482298e-02 2.024406e-03 1.482454e-02 9.998881e-01\n"
               "T: -8.086759e-01 3.195559e-01 -7.997231e-01\n")


def emit(record):
    print(json.dumps(record), flush=True)


def pool_segments():
    """{memory pool id: bytes the card's caching allocator holds for it},
    from its segments in torch.cuda.memory_snapshot(); (0, 0) is the
    default pool, the others CUDA graphs' private pools."""
    held = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        held[pool] = held.get(pool, 0) + seg["total_size"]
    return held


def pool_bytes(pool):
    """The bytes held for the CUDA graph memory pool `pool`."""
    return pool_segments().get(tuple(pool), 0)


def release_memory():
    """Collect garbage, then empty the card's allocator cache: a Trainer
    can sit in a reference cycle, and the memory pool of its CUDA graphs
    is freed only when the graphs are. Names on stderr the graph pools
    still held after it (graphs still alive)."""
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.is_available():
        held = {str(k): v for k, v in pool_segments().items() if k != (0, 0)}
        if held:
            print(f"[memory] graph pools still held: {held}", file=sys.stderr, flush=True)


def time_ms_per_call(fn, reps=20, warmup=3):
    """The median CUDA-event time of ONE call of fn, in ms: the events
    also take in the host's work before the launch (the earlier measure,
    kept as `ms_per_call_host_incl`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b):
    return float((a - b).abs().max())


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel_l2(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def bound(nbytes, ops):
    """(least time in ms, what bounds it) for the given bytes and ops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def write_calib(directory, height, width):
    """A KITTI-format calib for the frame size: the 2011_09_26 camera scaled
    to the image, the real velodyne->camera and IMU->velodyne transforms."""
    fx = 721.5377 * width / 1242.0
    fy = 721.5377 * height / 375.0
    cx, cy = width / 2.0, height * 0.46
    with open(os.path.join(directory, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"K_02: {fx} 0 {cx} 0 {fy} {cy} 0 0 1\n")
        f.write(f"P_rect_02: {fx} 0 {cx} 44.85728 0 {fy} {cy} 0.2163791 "
                "0 0 1 0.002745884\n")
        f.write("R_rect_02: 1 0 0 0 1 0 0 0 1\n")
    with open(os.path.join(directory, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 "
                "7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 "
                "1.480755e-02\nT: -4.069766e-03 -7.631618e-02 -2.717806e-01\n")
    with open(os.path.join(directory, "calib_imu_to_velo.txt"), "w") as f:
        f.write(IMU_TO_VELO)


def main(device="cuda:0"):
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 geometry stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build every kernel (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    paths = build.build_all()
    build.load_libraries()
    ptxas = {}
    for name, path in paths.items():
        log = path + ".log"
        if os.path.exists(log):
            with open(log) as f:
                ptxas[name] = [l.strip().removeprefix("ptxas info    : ") for l in f
                               if "Used" in l or "entry function" in l]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in paths.items()},
          "ptxas": ptxas})

    # 2b. the division helper of kernels B and C over every fp32 bit pattern
    div3_phase(device)

    config = load_config(CONFIG)
    height, width = config.image_shape
    batch_size = config.action.batch_size
    gen = torch.Generator().manual_seed(SEED)
    depth_model = build_model(config.model.depth.name, generator=gen, device=device)
    pose_model = build_model(config.model.pose.name, generator=gen, device=device)
    step = make_eval_step(
        depth_model, pose_model, loss_mode=config.action.loss_mode,
        depth_norm=config.action.depth_norm, precision=config.action.precision,
        device=device,
    )
    data = SyntheticTripletDataset(4, batch_size, height, width, seed=SEED,
                                   uint8_images=True)
    batches = list(data.batches())

    # 3-4, 7-8. kernels A, A', B and C vs their plain versions on the main
    # path's inputs, from a real validation step
    inputs = step.loss_inputs(batches[0])
    records, details = kernel_checks(inputs, batch_size, device)
    for phase, name in (("kernel_a", "warp_bilinear_fwd"), ("kernel_b", "ssim_fwd"),
                        ("kernel_a_bwd", "warp_bilinear_bwd"), ("kernel_c", "ssim_bwd")):
        emit({"phase": phase, **details[name]})

    # 5. serve: frames -> depth -> pseudo-LiDAR through the pipeline
    frames = [normalize_image(img.astype(np.float32) / 255.0)
              for b in batches[:2] for img in b["tgt"]][:20]
    with tempfile.TemporaryDirectory() as calib_dir:
        write_calib(calib_dir, height, width)
        pipeline = DepthToPointCloudPipeline(
            make_depth_fn(depth_model, precision=config.action.precision),
            PseudoLiDAR(calib_dir, device=device), device=device,
        )
        pipeline.process(frames[0])  # warm-up (cuDNN algorithm choice)
        kernels.reset_launch_counts()
        results = []
        t0 = time.perf_counter()
        processed = pipeline.run(iter(frames), results.append,
                                 queue_size=len(frames))
        serve_s = time.perf_counter() - t0
        serve_launches = dict(kernels.launch_counts)
        check(processed == len(frames) == len(results), "serve dropped frames")
        check(all(np.isfinite(r.depth).all() for r in results), "non-finite depth")
        check(all(r.points.shape[0] > 0 for r in results), "a frame gave no points")
        # the card's projector vs the same depth projected on the CPU
        depths = torch.from_numpy(np.stack([r.depth for r in results]))
        points, valid = pipeline.projector.project_batch(depths.to(device))
        cpu_points, cpu_valid = PseudoLiDAR(calib_dir, device="cpu").project_batch(depths)
    both = (valid.cpu() & cpu_valid).numpy()
    mask_mismatch = float((valid.cpu() != cpu_valid).float().mean())
    points_err = float(np.abs(points.cpu().numpy() - cpu_points.numpy())[both].max())
    check(mask_mismatch <= POINTS_MASK_MISMATCH,
          f"projector valid masks differ on {mask_mismatch} of pixels")
    check(points_err <= POINTS_ATOL, f"projector points cuda vs cpu: {points_err}")
    emit({"phase": "serve", "frames": processed, "height": height, "width": width,
          "frames_per_s": processed / serve_s,
          "mean_points_per_frame": float(np.mean([r.points.shape[0] for r in results])),
          "projector_points_max_abs_err_vs_cpu": points_err,
          "projector_mask_mismatch_vs_cpu": mask_mismatch,
          "graph_replays": pipeline.graphs.replays, "launches": serve_launches})

    # 6. validation: the main path; launches counted over exactly these steps
    for _ in range(2):  # warm-up: the eager first call, then the capture
        step(batches[1])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        metrics, depth_pred = step(b)
        losses.append(float(metrics["loss"]))  # syncs the step
    step_ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    launches = dict(kernels.launch_counts)
    steps = len(losses)
    check(np.isfinite(losses).all(), f"non-finite validation loss {losses}")
    check(depth_pred.shape == (batch_size, height, width), "depth shape")
    check(launches == {"warp_bilinear_fwd": steps, "warp_bilinear_bwd": 0,
                       "ssim_fwd": 2 * steps, "ssim_bwd": 0},
          f"main path launches {launches} for {steps} steps")
    # the loss on the card (kernels) vs the same fp32 tensors on the CPU
    # (plain versions)
    on_gpu = float(step.loss(inputs))
    on_cpu = float(step.loss(_to_cpu(inputs)))
    rel = abs(on_gpu - on_cpu) / abs(on_cpu)
    check(rel <= LOSS_RTOL, f"loss cuda {on_gpu} vs cpu {on_cpu}: rel {rel}")
    emit({"phase": "validation", "batch": batch_size, "steps": steps,
          "precision": config.action.precision, "ms_per_step": step_ms,
          "losses": losses, "launches": launches, "loss_cuda": on_gpu,
          "loss_cpu_plain": on_cpu, "rel_err": rel})
    del depth_model, pose_model, step, pipeline

    # 9. train: Trainer.run_epoch at the production config's full width
    # and batch
    train_launches = train_phase(config, device, batch_size, height, width)
    for name, record in records.items():
        record["launches"] = train_launches[name]

    # 10-12. the training CLI on basic_config, the kernels at its shapes,
    # and validation with the Eigen protocol and pose metrics
    with tempfile.TemporaryDirectory() as tmp:
        trainer, basic_launches = train_basic_phase(device, tmp)
        # the phases below validate only: the train step's graph pool goes
        trainer.train_step.graphs.reset()
        release_memory()
        records_1280, details_1280 = kernel_checks(
            trainer.eval_step.loss_inputs(
                next(SyntheticTripletDataset(1, trainer.config.action.batch_size,
                                             *trainer.config.image_shape,
                                             seed=SEED + 7, uint8_images=True).batches())),
            trainer.config.action.batch_size, device)
        for name, record in records_1280.items():
            record["launches"] = basic_launches[name]
        emit({"phase": "kernels_1280", "kernels": details_1280})
        eval_metrics_phase(trainer, device)
        del trainer
    release_memory()

    # 13. the 'mean' and 'ssim' objectives on configs/synthetic.yaml
    train_mean_phase(device)
    release_memory()
    # 13b. the step as one program: captured against eager, and its times
    graph_phase(device)
    release_memory()

    # 14. the KITTI path: splits, training, evaluation and odometry on a
    # KITTI-shaped drive through the CLIs; 15. the serving CLIs on its frames
    with tempfile.TemporaryDirectory() as tmp:
        kitti_launches, drive_dir, kitti = kitti_phase(device, tmp)
        release_memory()
        serve_cli_phase(device, tmp, drive_dir)
        release_memory()
        # 15b. serving as one program: captured pipelines against eager
        serve_graph_phase(device, tmp, drive_dir)
        release_memory()
        # 16. where a training step's time goes, by torch.profiler
        profiled = profile_phase(device, tmp, kitti, records_1280)
        release_memory()
        # 17. the rest of the model zoo: BtsModel serving at the ROS node's
        # shape, the multi-scale and transformer depth nets' training steps
        models_phase(device, tmp, drive_dir)
    release_memory()
    # 18. data parallelism: the step under a mesh, world 1 under NCCL and 2
    # gloo ranks sharing the card
    rank_launches = parallel_phase(device)
    release_memory()
    # 18b. the step captured under an NCCL mesh (world 1 in this process)
    mesh_graph_launches = mesh_graph_phase(device)
    release_memory()
    # 18c. the examples' counterparts: the toy problem and the turntable
    example_launches = examples_phase(device)
    release_memory()
    # 19. the "spatial" mesh axis: image rows sharded over gloo ranks
    spatial_launches = spatial_phase(device)
    for name, record in records_1280.items():
        record["launches_kitti"] = kitti_launches[name]
        record["launches_parallel_per_rank"] = [r[name] for r in rank_launches]
        record["launches_spatial_per_rank"] = [r[name] for r in spatial_launches]
        record["launches_mesh_graph_per_replay"] = mesh_graph_launches[name]
    for name, record in records.items():
        record["launches_examples"] = {k: v[name] for k, v in example_launches.items()}
    for config_name, recs in (("basic_config", records_1280), ("tpu_v5e", records)):
        for name, record in recs.items():
            record["profiled_ms_per_step"] = profiled[config_name][name]["ms_per_step"]
            record["profiled_launches"] = profiled[config_name][name]["launches"]
    release_memory()

    emit({"kernels": list(records.values()) + list(records_1280.values())})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def warp_jobs(inputs):
    """The 'min' objective's stacked warp jobs [ref0->tgt, ref1->tgt,
    tgt->ref0] on one step's loss inputs (depth_norm on): sources,
    targets and sample coordinates."""
    d_tgt = normalize_depth(disp_to_depth(inputs["disparities"][0][0]))[:, 0]
    d_ref0 = normalize_depth(disp_to_depth(inputs["disparities"][1][0]))[:, 0]
    t0_, t1_ = pose_matrix(inputs["poses"][:, 0]), pose_matrix(inputs["poses"][:, 1])
    transform = torch.cat([t0_, t1_, invert_pose(t0_)], dim=0)
    coords = warp_coords(torch.cat([d_tgt, d_tgt, d_ref0], dim=0), transform,
                         inputs["intrinsics"].repeat(3, 1, 1)).contiguous()
    src = torch.cat([inputs["refs"][0], inputs["refs"][1], inputs["tgt"]]).contiguous()
    target = torch.cat([inputs["tgt"], inputs["tgt"], inputs["refs"][0]]).contiguous()
    return src, target, coords


def kernel_checks(inputs, batch_size, device):
    """Kernels A, A', B and C against their plain versions on the warp
    jobs of one step's loss inputs (A and A' also on random coordinates,
    A also against F.grid_sample), each timed with its plain version and
    the library call where one exists; every failed check raises. Returns
    ({kernel: its record for the kernels line, launches to be filled in},
    {kernel: the fields of its phase line})."""
    src, target, coords = warp_jobs(inputs)
    jobs, _, height, width = src.shape
    gpu_gen = torch.Generator(device=device).manual_seed(SEED)
    # ~10% of the random samples fall outside [-1, 1]^2
    random_coords = (torch.rand(coords.shape, generator=gpu_gen, device=device)
                     * 2.0 - 1.0) * 1.05
    out_of_frame = float((random_coords.abs() > 1).any(-1).float().mean())
    pixels = jobs * height * width
    records, details = {}, {}

    # A vs its plain version (and F.grid_sample as a cross-check)
    warp_err, lib_err = 0.0, 0.0
    for grid in (coords, random_coords):
        got = kernels.warp_bilinear_fwd(src, grid)
        warp_err = max(warp_err, max_err(got, grid_sample(src, grid)))
        lib = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        lib_err = max(lib_err, max_err(got, lib))
    torch.cuda.synchronize()
    check(warp_err <= WARP_TOL, f"kernel A vs plain: {warp_err} > {WARP_TOL}")
    check(lib_err <= LIBRARY_TOL, f"kernel A vs F.grid_sample: {lib_err}")
    band_err = band_checks(src, coords, gpu_gen, device)
    warp_bound = bound(pixels * (8 + 12 + 12), pixels * WARP_OPS_PER_PIXEL)
    records["warp_bilinear_fwd"] = {
        "name": "warp_bilinear_fwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/warp_bilinear.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/warp.py:535",
        "shape": list(src.shape),
        "max_abs_err": warp_err,
        "max_abs_err_band_rows": band_err["warp_bilinear_fwd"],
        "ms": device_time_ms(lambda: kernels.warp_bilinear_fwd(src, coords)),
        "plain_ms": device_time_ms(lambda: grid_sample(src, coords)),
        "bound_ms": warp_bound[0], "bound_by": warp_bound[1],
        "library_ms": device_time_ms(lambda: F.grid_sample(
            src, coords, mode="bilinear", padding_mode="zeros",
            align_corners=True)),
        "ms_per_call_host_incl": time_ms_per_call(
            lambda: kernels.warp_bilinear_fwd(src, coords)),
    }
    details["warp_bilinear_fwd"] = {
        "shape": list(src.shape), "random_out_of_frame": out_of_frame,
        "max_abs_err_vs_F_grid_sample": lib_err,
        **{k: records["warp_bilinear_fwd"][k] for k in (
            "max_abs_err", "max_abs_err_band_rows", "ms", "plain_ms", "bound_ms", "library_ms",
            "ms_per_call_host_incl")}}

    # B vs its plain version on the main path's two calls: the identity
    # pair (2B jobs) and the warped stack (3B jobs)
    warped = kernels.warp_bilinear_fwd(src, coords)
    calls = {"identity": (src[: 2 * batch_size], target[: 2 * batch_size]),
             "warped": (warped, target)}
    ssim_err = 0.0
    ssim_times = {}
    ssim_ms = ssim_plain_ms = ssim_host_ms = ssim_bytes = ssim_ops = 0.0
    for label, (x, y) in calls.items():
        for weight in (1.0, 0.85):
            err = max_err(kernels.ssim_fwd(x, y, weight),
                          photometric_map(x, y, weight))
            ssim_err = max(ssim_err, err)
        k_ms = device_time_ms(lambda: kernels.ssim_fwd(x, y, 0.85))
        p_ms = device_time_ms(lambda: photometric_map(x, y, 0.85))
        h_ms = time_ms_per_call(lambda: kernels.ssim_fwd(x, y, 0.85))
        ssim_times[label] = {"shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms,
                             "ms_per_call_host_incl": h_ms}
        ssim_ms += k_ms
        ssim_plain_ms += p_ms
        ssim_host_ms += h_ms
        ssim_bytes += x.numel() * 12
        ssim_ops += x.numel() * SSIM_OPS_PER_PIXEL
    torch.cuda.synchronize()
    check(ssim_err <= SSIM_TOL, f"kernel B vs plain: {ssim_err} > {SSIM_TOL}")
    ssim_bound = bound(ssim_bytes, ssim_ops)
    records["ssim_fwd"] = {
        "name": "ssim_fwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/ssim.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py:76",
        "shape": [t["shape"] for t in ssim_times.values()],
        "max_abs_err": ssim_err, "ms": ssim_ms, "plain_ms": ssim_plain_ms,
        "bound_ms": ssim_bound[0], "bound_by": ssim_bound[1],
        "library_ms": None, "ms_per_call_host_incl": ssim_host_ms,
    }
    details["ssim_fwd"] = {"max_abs_err": ssim_err, "calls": ssim_times,
                           "ms_per_step": ssim_ms, "bound_ms_per_step": ssim_bound[0]}

    # A' vs its plain version on the path's coords and the random ones,
    # with a random cotangent
    g_warp = torch.randn(src.shape, generator=gpu_gen, device=device)
    warp_bwd_err = 0.0
    for grid in (coords, random_coords):
        ref = grid_sample_grad_grid(src, grid, g_warp)
        err = max_err(kernels.warp_bilinear_bwd_grid(src, grid, g_warp), ref)
        torch.cuda.synchronize()
        check(err <= BWD_RTOL * float(ref.abs().max()),
              f"kernel A' vs plain: {err} > {BWD_RTOL} x {float(ref.abs().max())}")
        warp_bwd_err = max(warp_bwd_err, err)
    lib_grid = coords.clone().requires_grad_()
    lib_out = F.grid_sample(src, lib_grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
    warp_bwd_bound = bound(pixels * (8 + 12 + 12 + 8), pixels * WARP_BWD_OPS_PER_PIXEL)
    records["warp_bilinear_bwd"] = {
        "name": "warp_bilinear_bwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/warp_bilinear.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/warp.py:535 "
                    "(with_taps=True, _fwd :551 + _bwd :569)",
        "shape": list(src.shape),
        "max_abs_err": warp_bwd_err,
        "max_abs_err_band_rows": band_err["warp_bilinear_bwd"],
        "ms": device_time_ms(lambda: kernels.warp_bilinear_bwd_grid(src, coords, g_warp)),
        "plain_ms": device_time_ms(lambda: grid_sample_grad_grid(src, coords, g_warp)),
        "bound_ms": warp_bwd_bound[0], "bound_by": warp_bwd_bound[1],
        # the grid-only gradient of the library's sampler
        "library_ms": device_time_ms(lambda: torch.autograd.grad(
            lib_out, lib_grid, g_warp, retain_graph=True)),
        "ms_per_call_host_incl": time_ms_per_call(
            lambda: kernels.warp_bilinear_bwd_grid(src, coords, g_warp)),
    }
    details["warp_bilinear_bwd"] = {
        "shape": list(src.shape),
        **{k: records["warp_bilinear_bwd"][k] for k in (
            "max_abs_err", "max_abs_err_band_rows", "ms", "plain_ms", "bound_ms", "library_ms",
            "ms_per_call_host_incl")}}

    # C vs its plain version on the warped stack (blend 0.85, the main
    # path's setting), dx only (the main path: the target is data) and
    # (dx, dy)
    g_ssim = torch.randn(warped.shape, generator=gpu_gen, device=device)
    ssim_bwd_err = 0.0
    for need_dy in (False, True):
        got = kernels.ssim_bwd(warped, target, g_ssim, 0.85, True, need_dy)
        ref = photometric_map_bwd(warped, target, g_ssim, 0.85, True, need_dy)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if b is None:
                check(a is None, "kernel C wrote a gradient it was not asked for")
                continue
            err = max_err(a, b)
            check(err <= BWD_RTOL * float(b.abs().max()),
                  f"kernel C vs plain: {err} > {BWD_RTOL} x {float(b.abs().max())}")
            ssim_bwd_err = max(ssim_bwd_err, err)
    ssim_bwd_bound = bound(warped.numel() * 16, warped.numel() * SSIM_BWD_OPS_PER_PIXEL)
    records["ssim_bwd"] = {
        "name": "ssim_bwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/ssim_bwd.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py:235",
        "shape": list(warped.shape),
        "max_abs_err": ssim_bwd_err,
        "ms": device_time_ms(lambda: kernels.ssim_bwd(warped, target, g_ssim, 0.85, True, False)),
        "plain_ms": device_time_ms(lambda: photometric_map_bwd(warped, target, g_ssim, 0.85,
                                                        True, False)),
        "bound_ms": ssim_bwd_bound[0], "bound_by": ssim_bwd_bound[1],
        "library_ms": None,  # no single PyTorch call computes it
        "ms_per_call_host_incl": time_ms_per_call(
            lambda: kernels.ssim_bwd(warped, target, g_ssim, 0.85, True, False)),
    }
    details["ssim_bwd"] = {
        "shape": list(warped.shape),
        "ms_dx_dy": device_time_ms(lambda: kernels.ssim_bwd(warped, target, g_ssim, 0.85)),
        **{k: records["ssim_bwd"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "ms_per_call_host_incl")}}
    return records, details


def band_checks(src, coords, gen, device):
    """Kernels A and A' on bands of grid rows, as a spatial mesh's ranks
    run them: each half of `coords`' rows (Hg = H/2), the uneven bands of
    the 32-row grain over 4 ranks (row_bands: 64/64/32/32 rows at 192)
    and an odd band (the last 33 rows), each over the whole images `src`,
    against their plain versions and against the band's rows of the whole
    grid's result, bit for bit (a failed check raises) -> {kernel: the
    largest difference, 0.0}."""
    height = coords.shape[1]
    g = torch.randn(src.shape, generator=gen, device=device)
    whole = kernels.warp_bilinear_fwd(src, coords)
    whole_grad = kernels.warp_bilinear_bwd_grid(src, coords, g)
    err = {"warp_bilinear_fwd": 0.0, "warp_bilinear_bwd": 0.0}
    bands = [(0, height // 2), (height // 2, height), *row_bands(height, 4),
             (height - 33, height)]
    for band in (slice(*rows) for rows in bands):
        grid, g_band = coords[:, band].contiguous(), g[:, :, band].contiguous()
        out = kernels.warp_bilinear_fwd(src, grid)
        d_grid = kernels.warp_bilinear_bwd_grid(src, grid, g_band)
        err["warp_bilinear_fwd"] = max(err["warp_bilinear_fwd"],
                                       max_err(out, grid_sample(src, grid)),
                                       max_err(out, whole[:, :, band]))
        err["warp_bilinear_bwd"] = max(err["warp_bilinear_bwd"],
                                       max_err(d_grid, grid_sample_grad_grid(src, grid, g_band)),
                                       max_err(d_grid, whole_grad[:, band]))
    torch.cuda.synchronize()
    check(err == {"warp_bilinear_fwd": 0.0, "warp_bilinear_bwd": 0.0},
          f"kernels A / A' on bands of grid rows vs plain: {err}")
    return err


def div3_phase(device, chunk=1 << 27):
    """ops/cuda/div3.cuh's x / 3 against the IEEE division x / 3.0
    (utils/numerics.div, what the plain versions compute) over all 2^32
    binary32 bit patterns, in chunks; NaN matches NaN by class. Prints the
    phase's record, then raises unless no pattern disagrees."""
    t0 = time.perf_counter()
    mismatches, nans = 0, 0
    first_bad = None
    for start in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(start, start + chunk, dtype=torch.int64,
                         device=device).to(torch.int32).view(torch.float32)
        got, ref = kernels.div3(x), div(x, 3.0)
        both_nan = torch.isnan(got) & torch.isnan(ref)
        bad = (got.view(torch.int32) != ref.view(torch.int32)) & ~both_nan
        count = int(bad.sum())
        if count and first_bad is None:
            first_bad = hex(int(x.view(torch.int32)[bad][0]) & 0xFFFFFFFF)
        mismatches += count
        nans += int(both_nan.sum())
    torch.cuda.synchronize()
    release_memory()
    emit({"phase": "div3", "patterns": 1 << 32, "mismatches": mismatches,
          "first_mismatch_bits": first_bad, "nan_patterns": nans,
          "seconds": time.perf_counter() - t0})
    check(mismatches == 0, f"div3 disagrees with x / 3.0 on {mismatches} patterns")


def expected_launches(loss_mode, scales=1, remat=False):
    """Launches of one training step: {A, A', B, C} by objective, for a
    depth net of `scales` output scales. 'min'
    (losses/reprojection.min_reprojection_loss) warps and scores each
    scale apart: per scale one A, one B on the warped frames, and in the
    backward one A' and one C; plus one B for the identity error, which
    is scale-free and needs no gradient -> {S, S, S + 1, S}. 'mean' and
    'ssim' (reprojection_loss) stack every scale's jobs into one warp and
    ('ssim') one SSIM pass -> {1, 1, 0, 0} and {1, 1, 1, 1} at any S. With
    remat the backward recomputes the loss's forward first: A and B twice."""
    launches = {"min": {"warp_bilinear_fwd": scales, "warp_bilinear_bwd": scales,
                        "ssim_fwd": scales + 1, "ssim_bwd": scales},
                "mean": {"warp_bilinear_fwd": 1, "warp_bilinear_bwd": 1,
                         "ssim_fwd": 0, "ssim_bwd": 0},
                "ssim": {"warp_bilinear_fwd": 1, "warp_bilinear_bwd": 1,
                         "ssim_fwd": 1, "ssim_bwd": 1}}[loss_mode]
    if remat:
        launches = {k: v * (2 if k in ("warp_bilinear_fwd", "ssim_fwd") else 1)
                    for k, v in launches.items()}
    return launches


def timed_epoch(trainer, batches):
    """trainer.run_epoch over `batches` with the launch counts reset just
    before and read just after -> (metrics, ms a step by host clock, ms a
    step by CUDA events, launches)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = trainer.run_epoch(batches)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    event_ms = start.elapsed_time(end) / len(batches)
    return metrics, host_ms, event_ms, dict(kernels.launch_counts)


def train_phase(config, device, batch_size, height, width):
    """Trainer.run_epoch over 1 warm-up and TRAIN_STEPS steps; prints the
    phase's record, then checks it, and returns the kernels' launches over
    those steps."""
    data = SyntheticTripletDataset(1 + TRAIN_STEPS, batch_size, height, width,
                                   seed=SEED, uint8_images=True)
    batches = list(data.batches())
    losses = []
    config.action.log_freq = 1  # one loss per step (a host sync per step)
    trainer = Trainer(config, data, log_fn=lambda m, step: losses.append(m["loss"]),
                      device=device)
    params = dict(trainer.state.depth_model.named_parameters(prefix="depth"))
    params.update(trainer.state.pose_model.named_parameters(prefix="pose"))
    trainer.run_epoch(batches[:1] * 2)  # warm-up: cuDNN's algorithm choice, the capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: p.detach().clone() for k, p in params.items()}
    losses.clear()
    metrics, host_ms, event_ms, launches = timed_epoch(trainer, batches[1:])
    with_grad = {k for k, p in params.items()
                 if p.grad is not None and bool((p.grad != 0).any())}
    stale = sorted(k for k in with_grad if torch.equal(before[k], params[k]))
    unchanged = sorted(k for k in params if torch.equal(before[k], params[k]))
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    grad_rel = loss_grad_rel(trainer, batches[1])
    act = config.action
    emit({
        "phase": "train", "batch": batch_size, "height": height, "width": width,
        "steps": TRAIN_STEPS, "precision": act.precision,
        "ms_per_step_host": host_ms, "ms_per_step_cuda_events": event_ms,
        "losses": losses, "final_metrics": metrics, "launches": launches,
        "parameters": len(params), "parameters_unchanged": len(unchanged),
        "unchanged": unchanged,
        "loss_grad_rel_l2_cuda_vs_cpu": grad_rel,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    expected = {k: TRAIN_STEPS * v for k, v in expected_launches(act.loss_mode).items()}
    check(launches == expected, f"train launches {launches}, expected {expected}")
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
          f"train losses {losses}")
    check(finite, "a parameter is not finite after training")
    check(not stale, f"parameters with a gradient did not change: {stale}")
    check(max(grad_rel.values()) <= GRAD_REL_L2,
          f"loss gradients cuda vs cpu: rel L2 {grad_rel} > {GRAD_REL_L2}")
    return launches


def loss_grad_rel(trainer, batch, inputs=None):
    """The loss-side gradients of one step: the batch's fp32 loss inputs
    (disparities of both frames, poses; or `inputs`, in the eval step's
    loss_inputs form) as leaves, the trainer's training objective on the
    card (kernels) and on the CPU (plain versions) -> {leaf: rel L2 of the
    card's gradient against the CPU's}."""
    act = trainer.config.action
    if inputs is None:
        inputs = trainer.eval_step.loss_inputs(batch)

    scales = len(inputs["disparities"][0])
    names = [f"{frame}{f'_s{i}' if i else ''}" for frame in ("disp_tgt", "disp_ref0")
             for i in range(scales)] + ["poses"]

    def loss_grads(inp):
        disps = [[d.clone().requires_grad_() for d in frame] for frame in inp["disparities"]]
        pose = inp["poses"].clone().requires_grad_()
        reproj, smooth, _ = total_loss(
            inp["tgt"], inp["refs"], disps, pose,
            inp["intrinsics"], mode=act.loss_mode, smooth_weight=act.smooth_weight,
            smooth_on=act.smooth_on, depth_norm=act.depth_norm,
            min_bidirectional=act.min_bidirectional,
        )
        return torch.autograd.grad(reproj + smooth, [*disps[0], *disps[1], pose],
                                   allow_unused=True)

    on_gpu = loss_grads(inputs)
    on_cpu = loss_grads(_to_cpu(inputs))
    out = {}
    for name, a, b in zip(names, on_gpu, on_cpu):
        if a is None and b is None:
            out[name] = 0.0  # an input the objective does not read
        elif a is None or b is None:
            out[name] = float("inf")
        elif float(b.abs().max()) == 0.0:
            out[name] = float(a.abs().max())  # both exactly 0 where they agree
        else:
            out[name] = rel_l2(a.cpu(), b)
    return out


def _state_tensors(trainer):
    """Every parameter, buffer and Adam moment of a Trainer, by name."""
    state = trainer.state
    out = {f"depth.{k}": v for k, v in state.depth_model.state_dict().items()}
    out.update({f"pose.{k}": v for k, v in state.pose_model.state_dict().items()})
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in slots.items()})
    return out


def train_basic_phase(device, tmp):
    """The training CLI on configs/basic_config.yaml for BASIC_EPOCHS
    epochs of BASIC_BATCHES synthetic batches, its checkpoints under
    `tmp`; then a fresh Trainer with from_scratch False (and the Eigen
    protocol and pose metrics for eval_metrics) restores the last one and
    takes 1 warm-up and TRAIN_STEPS timed steps. Prints the phase's
    record, checks it, and returns (the restored trainer, the CLI run's
    launches)."""
    with open(BASIC_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["action"]["checkpoint_dir"] = os.path.join(tmp, "checkpoints")
    config_path = os.path.join(tmp, "basic_config.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(raw, f)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_trainer = train_cli.main(["--config", config_path, "--synthetic",
                                  "--epochs", str(BASIC_EPOCHS),
                                  "--synthetic-batches", str(BASIC_BATCHES)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    cli_steps = BASIC_EPOCHS * BASIC_BATCHES
    files = sorted(os.listdir(cli_trainer.checkpoints.directory))
    cli_graphs = cli_trainer.train_step.graphs
    cli_captured = {"graphs": len(cli_graphs.graphs), "replays": cli_graphs.replays}

    raw["action"].update(from_scratch=False, eval_protocol="eigen", eval_pose=True)
    with open(config_path, "w") as f:
        yaml.safe_dump(raw, f)
    config = load_config(config_path)
    batch_size = config.action.batch_size
    height, width = config.image_shape
    trainer = Trainer(config, SyntheticTripletDataset(BASIC_BATCHES, batch_size, height,
                                                      width), device=device)
    a, b = _state_tensors(cli_trainer), _state_tensors(trainer)
    differ = sorted(k for k in a if k not in b or not torch.equal(a[k], b[k]))
    restored = {"epoch": trainer.epoch, "step": trainer.state.step,
                "tensors": len(b), "tensors_differing": len(differ),
                "adam_tensors": sum(k.startswith("adam.") for k in b)}
    check(sorted(a) == sorted(b), "the restored state has other tensors")
    del cli_trainer, a, b
    release_memory()

    batches = list(SyntheticTripletDataset(1 + TRAIN_STEPS, batch_size, height, width,
                                           seed=SEED + 3, uint8_images=True).batches())
    trainer.run_epoch(batches[:1] * 2)  # warm-up: the eager first step, the capture
    torch.cuda.reset_peak_memory_stats()
    metrics, host_ms, event_ms, step_launches = timed_epoch(trainer, batches[1:])
    grad_rel = loss_grad_rel(trainer, batches[1])
    captured = {"graphs": len(trainer.train_step.graphs.graphs),
                "replays": trainer.train_step.graphs.replays}
    emit({
        "phase": "train_basic", "config": "configs/basic_config.yaml",
        "models": [config.model.depth.name, config.model.pose.name],
        "batch": batch_size, "height": height, "width": width,
        "precision": config.action.precision, "loss_mode": config.action.loss_mode,
        "cli_epochs": BASIC_EPOCHS, "cli_steps": cli_steps, "cli_seconds": cli_s,
        "cli_launches": launches, "checkpoints": files, "restored": restored,
        "cli_train_graphs": cli_captured, "resumed_train_graphs": captured,
        "steps": TRAIN_STEPS, "ms_per_step_host": host_ms,
        "ms_per_step_cuda_events": event_ms, "final_metrics": metrics,
        "launches": step_launches, "loss_grad_rel_l2_cuda_vs_cpu": grad_rel,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    check(files == [f"epoch_{e:05d}.pth" for e in range(BASIC_EPOCHS)],
          f"checkpoints written: {files}")
    per_step_launches = expected_launches(config.action.loss_mode)
    check(launches == {k: cli_steps * v for k, v in per_step_launches.items()},
          f"CLI launches {launches} for {cli_steps} steps")
    check(step_launches == {k: TRAIN_STEPS * v for k, v in per_step_launches.items()},
          f"resumed launches {step_launches} for {TRAIN_STEPS} steps")
    check(not differ, f"restore differs on {differ[:10]}")
    # the CLI's steps after its first ran captured: one graph, replayed
    check(cli_captured == {"graphs": 1, "replays": cli_steps - 1},
          f"the CLI's train graphs {cli_captured}")
    check(captured == {"graphs": 1, "replays": 1 + TRAIN_STEPS}, f"resumed graphs {captured}")
    check(restored["epoch"] == BASIC_EPOCHS and restored["step"] == cli_steps,
          f"resumed at {restored}")
    check(all(np.isfinite(v) for v in metrics.values()), f"train metrics {metrics}")
    check(max(grad_rel.values()) <= GRAD_REL_L2,
          f"loss gradients cuda vs cpu: rel L2 {grad_rel} > {GRAD_REL_L2}")
    return trainer, launches


def eval_metrics_phase(trainer, device, steps=3):
    """Trainer.validate over 1 warm-up and `steps` synthetic batches with
    the Eigen protocol and pose metrics: every depth and pose metric
    present and finite, and the metrics of one batch on the card equal to
    the same tensors' on the CPU (rel METRIC_RTOL)."""
    config = trainer.config
    batches = list(SyntheticTripletDataset(1 + steps, config.action.batch_size,
                                           *config.image_shape, seed=SEED + 11,
                                           uint8_images=True).batches())
    trainer.validate(batches[:1] * 2)  # warm-up: the eager first call, the capture
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    val = trainer.validate(batches[1:])
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = dict(kernels.launch_counts)

    step = trainer.eval_step
    inputs = step.loss_inputs(batches[1])
    depth_pred = disp_to_depth(inputs["disparities"][0][0][:, 0])
    on_gpu = {k: float(v) for k, v in step.metrics(inputs, depth_pred).items()}
    on_cpu = {k: float(v) for k, v in
              step.metrics(_to_cpu(inputs), depth_pred.cpu()).items()}
    rel = {k: _rel(on_gpu[k], on_cpu[k]) for k in on_cpu}
    emit({"phase": "eval_metrics", "protocol": config.action.eval_protocol,
          "pose_metrics": config.action.eval_pose, "steps": steps,
          "ms_per_step_host": host_ms, "metrics": val, "launches": launches,
          "metrics_cuda": on_gpu, "metrics_cpu": on_cpu, "rel_err_cuda_vs_cpu": rel})
    expected = ["loss", *METRICS, "pose_ate", "pose_ate_unscaled", "pose_rot_err_deg",
                "pose_scale"]
    check(sorted(val) == sorted(expected), f"validation metrics {sorted(val)}")
    check(sorted(on_gpu) == sorted(expected[1:]), f"metrics {sorted(on_gpu)}")
    check(all(np.isfinite(v) for v in val.values()), f"non-finite metrics {val}")
    check(launches == {"warp_bilinear_fwd": steps, "warp_bilinear_bwd": 0,
                       "ssim_fwd": 2 * steps, "ssim_bwd": 0},
          f"validation launches {launches} for {steps} steps")
    check(max(rel.values()) <= METRIC_RTOL,
          f"metrics cuda vs cpu: {rel} > {METRIC_RTOL}")


def train_mean_phase(device):
    """configs/synthetic.yaml ('mean': one stacked warp of the 3·S·B jobs,
    no SSIM) for 1 warm-up and TRAIN_STEPS timed steps, then one step of
    the 'ssim' objective on the same config: launches by objective, and
    the loss-side gradients on the card vs the CPU."""
    out = {"phase": "train_mean", "config": "configs/synthetic.yaml"}
    checks = []
    for mode, steps in (("mean", TRAIN_STEPS), ("ssim", 1)):
        config = load_config(MEAN_CONFIG)
        config.action.loss_mode = mode
        batch_size = config.action.batch_size
        height, width = config.image_shape
        data = SyntheticTripletDataset(1 + steps, batch_size, height, width,
                                       seed=SEED + 5, uint8_images=True)
        batches = list(data.batches())
        trainer = Trainer(config, data, device=device)
        trainer.run_epoch(batches[:1] * 2)  # warm-up: the eager first step, the capture
        metrics, host_ms, event_ms, launches = timed_epoch(trainer, batches[1:])
        grad_rel = loss_grad_rel(trainer, batches[1])
        expected = {k: steps * v for k, v in expected_launches(mode).items()}
        out[mode] = {"batch": batch_size, "height": height, "width": width,
                     "steps": steps, "ms_per_step_host": host_ms,
                     "ms_per_step_cuda_events": event_ms, "final_metrics": metrics,
                     "launches": launches, "loss_grad_rel_l2_cuda_vs_cpu": grad_rel}
        checks += [
            (launches == expected, f"{mode}: launches {launches}, expected {expected}"),
            (all(np.isfinite(v) for v in metrics.values()), f"{mode}: metrics {metrics}"),
            (max(grad_rel.values()) <= GRAD_REL_L2,
             f"{mode}: loss gradients cuda vs cpu: rel L2 {grad_rel} > {GRAD_REL_L2}"),
        ]
        del trainer
        release_memory()
    emit(out)
    for ok, what in checks:
        check(ok, what)


def write_kitti_drive(root):
    """A KITTI raw drive at KITTI's frame size under root/kitti and its
    data_depth_annotated tree under root/depth: KITTI_FRAMES RGB PNGs (the
    synthetic scene's slanted textured plane, seen by a camera stepping 8
    pixels a frame), OXTS lines of a car driving ~1 m a frame and turning
    slightly, velodyne scans of KITTI_POINTS points (some behind the car or
    out of frame) and, for the interior frames, 16-bit depth PNGs of the
    scan rasterized at the frame size. Returns (kitti root, depth root,
    drive directory)."""
    height, width = KITTI_FRAME
    date = "2011_09_26"
    drive = f"{date}_drive_0001_sync"
    date_dir = os.path.join(root, "kitti", date)
    drive_dir = os.path.join(date_dir, drive)
    dirs = {name: os.path.join(drive_dir, name, "data")
            for name in ("image_02", "oxts", "velodyne_points")}
    gt_dir = os.path.join(root, "depth", "train", drive, "proj_depth", "groundtruth",
                          "image_02")
    for d in (*dirs.values(), gt_dir):
        os.makedirs(d)
    write_calib(date_dir, height, width)
    calib = Calibration(date_dir)
    velo_to_rect = torch.from_numpy((calib.R_rect @ calib.T_velo_cam).astype(np.float32))
    proj = torch.from_numpy(calib.P.astype(np.float32))
    step_px = 8
    strip = synthetic_triplet_batch(1, height, width + step_px * KITTI_FRAMES, seed=SEED,
                                    slant_deg=20.0)["tgt"][0]
    strip = (strip * 255).astype(np.uint8)
    rng = np.random.default_rng(SEED)
    rest = " ".join(["0.0"] * 17) + " 0.05 0.02 4 10 4 0 4"
    for k in range(KITTI_FRAMES):
        name = f"{k:010d}"
        Image.fromarray(strip[:, step_px * k: step_px * k + width]).save(
            os.path.join(dirs["image_02"], name + ".png"))
        with open(os.path.join(dirs["oxts"], name + ".txt"), "w") as f:
            f.write(f"{49.0 + 6e-6 * k:.10f} {8.43 + 1e-5 * k:.10f} {114.5 + 0.01 * k:.4f} "
                    f"0.01 0.005 {0.3 + 0.002 * k:.6f} {rest}\n")
        scan = np.stack([rng.uniform(-20.0, 80.0, KITTI_POINTS),
                         rng.uniform(-40.0, 40.0, KITTI_POINTS),
                         rng.uniform(-2.5, 2.0, KITTI_POINTS),
                         rng.uniform(0.0, 1.0, KITTI_POINTS)], -1).astype(np.float32)
        scan.tofile(os.path.join(dirs["velodyne_points"], name + ".bin"))
        if 0 < k < KITTI_FRAMES - 1:
            depth = project_velo_to_depth_image(torch.from_numpy(scan), velo_to_rect, proj,
                                                width, height).numpy()
            Image.fromarray(np.round(depth * 256.0).astype(np.uint16)).save(
                os.path.join(gt_dir, name + ".png"))
    return os.path.join(root, "kitti"), os.path.join(root, "depth"), drive_dir


def _quiet(fn, *args):
    """fn(*args) with its standard output captured -> (result, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def _rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a)


def kitti_phase(device, tmp):
    """The KITTI path through the port's CLIs on a KITTI-shaped drive (see
    write_kitti_drive). Prints the phase's record, then checks it; returns
    (the kernels' launches of the training CLI's run, the drive's
    directory)."""
    t_phase = time.perf_counter()
    out, checks = {"phase": "kitti", "frame": list(KITTI_FRAME), "frames": KITTI_FRAMES,
                   "points_per_scan": KITTI_POINTS}, []
    t0 = time.perf_counter()
    kitti_root, depth_root, drive_dir = write_kitti_drive(os.path.join(tmp, "data"))
    out["write_seconds"] = time.perf_counter() - t0

    # 1. split files through cli.splits
    annotated, drive_split = os.path.join(tmp, "annotated.txt"), os.path.join(tmp, "drive.txt")
    ann_lines, _ = _quiet(splits_cli.main, ["annotated", "--kitti", kitti_root, "--depth",
                                            depth_root, "--out", annotated])
    drv_lines, _ = _quiet(splits_cli.main, ["drive", "--drive", drive_dir, "--out", drive_split])
    out["split_lines"] = {"annotated": len(ann_lines), "drive": len(drv_lines)}
    checks.append((len(ann_lines) == len(drv_lines) == KITTI_FRAMES - 2,
                   f"split lines {out['split_lines']}"))

    # 2. cli.train on basic_config pointed at the drive: color jitter and
    # flips, 1 epoch, thread workers
    with open(BASIC_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["datasets"].update(path=kitti_root, split=annotated)
    raw["datasets"]["augmentation"].update(color_jitter=True, hflip=True)
    raw["action"].update(checkpoint_dir=os.path.join(tmp, "checkpoints"), log_freq=1,
                         num_workers=KITTI_WORKERS)
    config_path = os.path.join(tmp, "kitti_config.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(raw, f)
    config = load_config(config_path)
    batch_size = config.action.batch_size
    val_count = int(np.floor(config.action.split[1] * len(ann_lines)))
    steps, val_batches = (len(ann_lines) - val_count) // batch_size, val_count // batch_size
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, log = _quiet(train_cli.main, ["--config", config_path, "--epochs", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    records = [json.loads(line) for line in log.splitlines() if line.startswith("{")]
    losses = [r["loss"] for r in records if "loss" in r]
    files = sorted(os.listdir(trainer.checkpoints.directory))
    graphs = trainer.train_step.graphs
    per_step, per_val = expected_launches("min"), {"warp_bilinear_fwd": 1, "warp_bilinear_bwd": 0,
                                                    "ssim_fwd": 2, "ssim_bwd": 0}
    expected = {k: steps * per_step[k] + val_batches * per_val[k] for k in per_step}
    out["train"] = {"config": "configs/basic_config.yaml", "batch": batch_size,
                    "image": list(config.image_shape), "steps": steps,
                    "val_batches": val_batches, "cli_seconds": cli_s, "losses": losses,
                    "last_record": records[-1] if records else None, "launches": launches,
                    "expected_launches": expected, "checkpoints": files,
                    "train_graphs": len(graphs.graphs), "train_replays": graphs.replays}
    checks += [
        (launches == expected, f"kitti CLI launches {launches}, expected {expected}"),
        (len(losses) == steps + 1 and np.isfinite(losses).all(), f"kitti losses {losses}"),
        (files == ["epoch_00000.pth"], f"kitti checkpoints {files}"),
        (len(graphs.graphs) == 1 and graphs.replays == steps - 1,
         f"kitti: {len(graphs.graphs)} train graphs, {graphs.replays} replays in {steps} steps"),
    ]

    # the same trainer over two more passes of the drive in one loader
    # (8 threads, no decode cache) through prefetch_to_device, timed in the
    # steady state: a CUDA event recorded after each step, ms a step from
    # the first step's end to the last's (the loader's first fill, which
    # the first step waits for, stays out), and the loop's wait for each
    # batch, the first apart from the rest
    dataset = UnSupKittiDataset(config)
    train_idx, _ = dataset.train_val_indices(config.action.random_seed, config.action.split[1],
                                             config.datasets.augmentation.shuffle)
    trainer.log_fn = None  # no host sync a step
    step_fn, ends = trainer.train_step, []

    def timed_step(b):
        result = step_fn(b)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return result

    trainer.train_step = timed_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.run_epoch(prefetch_to_device(
        dataset.batches(train_idx * 2, batch_size, KITTI_WORKERS, with_groundtruth=False),
        device=device))
    torch.cuda.synchronize()
    out["timed_seconds"] = time.perf_counter() - t0
    trainer.train_step = step_fn
    # the step's graphs are not needed past here: their pool (~36 GB at
    # 1280x384 with TF32 off) is freed before the next Trainer steps
    step_fn.graphs.reset()
    release_memory()
    waits = [w * 1e3 for w in trainer.batch_waits]
    out["steps_timed"] = len(ends)
    out["ms_per_step"] = ends[0].elapsed_time(ends[-1]) / (len(ends) - 1)
    out["first_batch_wait_ms"] = waits[0]
    out["wait_ms_per_step"] = float(np.mean(waits[1:]))
    out["wait_ms_each_step"] = waits
    out["final_metrics"] = metrics
    checks.append((all(np.isfinite(v) for v in metrics.values()), f"kitti metrics {metrics}"))

    # 3. one semi_sup_pose step (no flips): the pose net does not move
    raw_semi = dict(raw, action=dict(raw["action"], semi_sup_pose=True),
                    datasets=dict(raw["datasets"], augmentation=dict(
                        raw["datasets"]["augmentation"], hflip=False)))
    semi_path = os.path.join(tmp, "kitti_semi.yaml")
    with open(semi_path, "w") as f:
        yaml.safe_dump(raw_semi, f)
    semi = Trainer(load_config(semi_path), dataset, device=device)
    batch = next(iter(dataset.batches(train_idx[:batch_size], batch_size, KITTI_WORKERS,
                                      with_groundtruth=False)))
    pose_before = {k: v.clone() for k, v in semi.state.pose_model.state_dict().items()}
    depth_before = {k: v.clone() for k, v in semi.state.depth_model.state_dict().items()}
    kernels.reset_launch_counts()
    semi_metrics = semi.run_epoch([batch])
    semi_launches = dict(kernels.launch_counts)
    pose_moved = [k for k, v in semi.state.pose_model.state_dict().items()
                  if not torch.equal(v, pose_before[k])]
    depth_moved = sum(not torch.equal(v, depth_before[k])
                      for k, v in semi.state.depth_model.state_dict().items())
    out["semi_sup_pose"] = {"metrics": semi_metrics, "pose_tensors_changed": len(pose_moved),
                            "depth_tensors_changed": depth_moved, "launches": semi_launches}
    checks += [
        (not pose_moved, f"semi_sup_pose moved the pose net: {pose_moved[:5]}"),
        (depth_moved > 0, "semi_sup_pose did not train the depth net"),
        (all(np.isfinite(v) for v in semi_metrics.values()), f"semi metrics {semi_metrics}"),
        (semi_launches == per_step, f"semi launches {semi_launches}"),
    ]
    del semi

    # 4. the loss-side gradients of one augmented batch, card vs CPU: the
    # parameters drawn once, applied on each device
    params = draw_params(batch_size, config.action.random_seed, trainer.state.step)
    on_card = augment_batch(normalize_uint8_batch(batch_to_device(batch, device)), params,
                            jitter=True, flip=True)
    on_cpu = augment_batch(normalize_uint8_batch(batch_to_device(batch, torch.device("cpu"))),
                           params, jitter=True, flip=True)
    aug_err = max(max_err(on_card[k].cpu(), on_cpu[k]) for k in ("tgt", "ref_imgs", "intrinsics"))
    with torch.no_grad():
        d_tgt, d_ref0, poses = forward_batch(trainer.state.depth_model,
                                             trainer.state.pose_model, on_card)
    inputs = {"tgt": on_card["tgt"],
              "refs": [on_card["ref_imgs"][:, 0], on_card["ref_imgs"][:, 1]],
              "disparities": [[d.float() for d in d_tgt], [d.float() for d in d_ref0]],
              "poses": poses.float(), "intrinsics": on_card["intrinsics"]}
    grad_rel = loss_grad_rel(trainer, None, inputs)
    out["augmented_grads"] = {"flips": int(params.flip.sum()),
                              "augmented_inputs_max_abs_err_cuda_vs_cpu": aug_err,
                              "loss_grad_rel_l2_cuda_vs_cpu": grad_rel}
    checks += [(aug_err <= 1e-6, f"augmentation card vs CPU: {aug_err}"),
               (max(grad_rel.values()) <= GRAD_REL_L2,
                f"augmented loss gradients cuda vs cpu: rel L2 {grad_rel} > {GRAD_REL_L2}")]
    del trainer, on_card, on_cpu, inputs
    release_memory()

    # 5. cli.evaluate from the epoch-0 checkpoint: the Eigen protocol and
    # pose metrics on the annotated split, velodyne ground truth on the
    # drive split; the card (kernels) vs --device cpu (plain versions).
    # The two runs' model forwards are independent (cuDNN vs the CPU's
    # convolutions, ~1e-6 apart): the metrics continuous in the depth map
    # are held at METRIC_RTOL, and d1-d3 — fractions of pixels under a
    # ratio threshold, where a pixel within 1e-6 of 1.25^k crosses it — to
    # one pixel an image. Every metric is held at METRIC_RTOL on the same
    # tensors (a KITTI batch's loss inputs on the card and on the CPU).
    out["evaluate"] = {}
    eval_batches = 1  # the CPU run of DispResNet-18 at 1280x384 dominates the phase
    for label, extra in (("annotated_eigen", ["--protocol", "eigen", "--pose-metrics"]),
                         ("drive_velo_gt", ["--split", drive_split, "--velo-gt",
                                            "--protocol", "eigen"])):
        argv = ["--config", config_path, "--max-batches", str(eval_batches), *extra]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card_metrics, _ = _quiet(eval_cli.main, argv)
        card_s = time.perf_counter() - t0
        eval_launches = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        cpu_metrics, _ = _quiet(eval_cli.main, [*argv, "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        rel = {k: _rel(card_metrics[k], cpu_metrics[k]) for k in cpu_metrics}
        # one pixel an image: the mean over images of 1 / valid pixels
        eval_config = load_config(config_path)
        if "--velo-gt" in extra:
            eval_config.datasets.split, eval_config.datasets.velo_gt = drive_split, True
        eval_data = UnSupKittiDataset(eval_config)
        crop = eigen_crop_mask(*eval_config.image_shape)
        valid = [int((crop & (gt > 1e-3) & (gt < 80.0)).sum()) for gt in (
            torch.from_numpy(eval_data.load_sample(i)["groundtruth"])
            for i in range(min(len(eval_data), eval_batches * batch_size)))]
        one_pixel = float(np.mean([1.0 / n for n in valid]))
        thresholds = ("d1", "d2", "d3")
        out["evaluate"][label] = {"metrics_cuda": card_metrics, "metrics_cpu": cpu_metrics,
                                  "rel_err_cuda_vs_cpu": rel, "cuda_seconds": card_s,
                                  "cpu_seconds": cpu_s,
                                  "valid_pixels": valid, "one_pixel_an_image": one_pixel,
                                  "launches": eval_launches}
        want = ["loss", *METRICS] + (["pose_ate", "pose_ate_unscaled", "pose_rot_err_deg",
                                      "pose_scale"] if "--pose-metrics" in extra else [])
        continuous = {k: v for k, v in rel.items() if k not in thresholds}
        flips = {k: abs(card_metrics[k] - cpu_metrics[k]) for k in thresholds}
        checks += [
            (sorted(card_metrics) == sorted(want), f"{label} metrics {sorted(card_metrics)}"),
            (all(np.isfinite(v) for v in card_metrics.values()), f"{label}: {card_metrics}"),
            (max(continuous.values()) <= METRIC_RTOL,
             f"{label} cuda vs cpu: {continuous} > {METRIC_RTOL}"),
            (max(flips.values()) <= one_pixel * (1 + 1e-6),
             f"{label} d1-d3 cuda vs cpu: {flips} > one pixel an image {one_pixel}"),
            (eval_launches == {k: eval_batches * v for k, v in per_val.items()},
             f"{label} launches {eval_launches}"),
        ]
    restored = Trainer(load_config(config_path), dataset, device=device)
    restored.checkpoints.restore(restored.state)
    step = make_eval_step(restored.state.depth_model, restored.state.pose_model,
                          loss_mode=config.action.loss_mode, depth_norm=config.action.depth_norm,
                          eval_protocol="eigen", pose_metrics=True, device=device)
    inputs = step.loss_inputs(next(iter(dataset.batches(list(range(batch_size)), batch_size,
                                                        KITTI_WORKERS))))
    depth_pred = disp_to_depth(inputs["disparities"][0][0][:, 0])
    same_card = {k: float(v) for k, v in step.metrics(inputs, depth_pred).items()}
    same_cpu = {k: float(v) for k, v in
                step.metrics(_to_cpu(inputs), depth_pred.cpu()).items()}
    same_rel = {k: _rel(same_card[k], same_cpu[k]) for k in same_cpu}
    out["evaluate"]["same_tensors"] = {"metrics_cuda": same_card, "rel_err_cuda_vs_cpu": same_rel}
    checks += [(max(same_rel.values()) <= METRIC_RTOL,
                f"metrics on the same tensors cuda vs cpu: {same_rel} > {METRIC_RTOL}"),
               (len(same_card) == len(METRICS) + 4, f"same-tensor metrics {sorted(same_card)}")]
    del restored, step, inputs
    release_memory()

    # 6. the velodyne rasterizer on one full scan at the training size
    height, width = config.image_shape
    calib = Calibration(os.path.dirname(drive_dir))
    proj = calib.P.astype(np.float32).copy()
    proj[0] *= width / KITTI_FRAME[1]
    proj[1] *= height / KITTI_FRAME[0]
    scan = torch.from_numpy(load_velo_scan(os.path.join(drive_dir, "velodyne_points", "data",
                                                        "0000000000.bin")))
    velo_to_rect = torch.from_numpy((calib.R_rect @ calib.T_velo_cam).astype(np.float32))
    args = (velo_to_rect, torch.from_numpy(proj), width, height)
    cpu_img = project_velo_to_depth_image(scan, *args)
    card_scan = scan.to(device)
    card_img = project_velo_to_depth_image(card_scan, *args).cpu()
    both = (card_img > 0) & (cpu_img > 0)
    differ = int(((card_img > 0) != (cpu_img > 0)).sum())
    value_rel = float(((card_img - cpu_img).abs() / cpu_img.clamp(min=1e-9))[both].max())
    out["velo2img"] = {"points": int(scan.shape[0]), "pixels_set": int((cpu_img > 0).sum()),
                       "pixels_differing": differ, "max_rel_err": value_rel,
                       "ms": device_time_ms(lambda: project_velo_to_depth_image(
                           card_scan, *args))}
    checks += [(differ <= 2, f"velo2img card vs CPU: {differ} pixels differ"),
               (value_rel <= VELO_RTOL, f"velo2img values: rel {value_rel}")]

    # 7. cli.odometry over the drive (its pose forward a CUDA graph), and
    # its ground truth against a float64 recomputation from the OXTS
    # files; the trajectory against an eager run of the same checkpoint,
    # on the whole drive and cut to ODOMETRY_PADDED_WINDOWS windows (a
    # last batch padded), cuDNN deterministic
    poses_out, gt_out = os.path.join(tmp, "poses.txt"), os.path.join(tmp, "gt_poses.txt")
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        odo, _ = _quiet(odometry_cli.main, ["--config", config_path, "--out", poses_out,
                                            "--gt-out", gt_out])
        odo_s = time.perf_counter() - t0
        same = {}
        for windows in (0, ODOMETRY_PADDED_WINDOWS):  # 0: every window
            texts = []
            for graph in (None, False):
                path = os.path.join(tmp, f"poses_{graph}_{windows}.txt")
                _quiet(odometry_cli.main, ["--config", config_path, "--out", path,
                                           "--max-windows", str(windows)], graph)
                with open(path) as f:
                    texts.append(f.read())
            same[windows or "all"] = texts[0] == texts[1]
    finally:
        torch.backends.cudnn.deterministic = False
    with open(poses_out) as f:
        pred_lines = f.read().splitlines()
    with open(gt_out) as f:
        gt_lines = f.read().splitlines()
    world = load_oxts_packets_and_poses(sorted(
        os.path.join(drive_dir, "oxts", "data", n)
        for n in os.listdir(os.path.join(drive_dir, "oxts", "data"))))
    c = calib.imu_to_cam
    t0_inv = np.linalg.inv(world[0])
    recomputed = kitti_odometry_lines(
        np.stack([c @ t0_inv @ t @ np.linalg.inv(c) for t in world]))
    out["odometry"] = {"lines": len(pred_lines), "gt_lines": len(gt_lines),
                       "gt_equals_recomputation": gt_lines == recomputed,
                       "metrics": odo, "seconds": odo_s, "captured_equals_eager": same}
    checks += [
        (all(same.values()), f"odometry captured vs eager trajectories: {same}"),
        (len(pred_lines) == len(gt_lines) == KITTI_FRAMES, f"odometry lines {out['odometry']}"),
        (gt_lines == recomputed, "the odometry GT file differs from the float64 recomputation"),
        (all(np.isfinite(odo[k]) for k in odo if k.startswith("pose_")), f"odometry {odo}"),
    ]

    # the loader alone: ms a batch at KITTI_WORKERS threads (decode, resize,
    # OXTS), the decoded-image cache cold and then warm
    config.datasets.cache_dir = os.path.join(tmp, "decode_cache")
    cached = UnSupKittiDataset(config)
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        count = sum(1 for _ in cached.batches(train_idx, batch_size, KITTI_WORKERS,
                                              with_groundtruth=False))
        out[f"loader_ms_per_batch_{label}"] = (time.perf_counter() - t0) * 1e3 / count
    out["loader_workers"] = KITTI_WORKERS
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)
    return launches, drive_dir, out


def paced_latency(pipeline, image_dir, height, width):
    """`pipeline` over the drive's frames at the reference's SERVE_RATE_HZ
    (FileImageSource + run, latest-wins queue of 1): the latency a frame,
    from the source yielding it to its result, in ms. Two frames go
    through it first, unpaced (`warmup_ms`): a pipeline's first call of
    a shape runs eagerly and its second captures the CUDA graph, which a
    live stream would pay on its second frame (and the frames queued
    behind it)."""
    first = next(iter(FileImageSource(image_dir, size_hw=(height, width))))
    warmup = []
    for _ in range(2):
        t0 = time.perf_counter()
        pipeline.process(first)
        warmup.append((time.perf_counter() - t0) * 1e3)
    yielded, latencies = {}, []

    def stamped(frames):
        for i, img in enumerate(frames):
            yielded[i] = time.perf_counter()
            yield img

    def on_result(result):
        latencies.append((time.perf_counter() - yielded[result.frame_index]) * 1e3)

    paced = FileImageSource(image_dir, rate_hz=SERVE_RATE_HZ, size_hw=(height, width))
    processed = pipeline.run(stamped(paced), on_result, queue_size=1)
    return {"rate_hz": SERVE_RATE_HZ, "queue_size": 1, "frames": processed,
            "warmup_ms": warmup,
            "graph_replays": pipeline.graphs.replays if pipeline.graphs else None,
            "latency_ms_median": float(np.median(latencies)),
            "latency_ms_max": float(np.max(latencies)), "latency_ms": latencies}


def serve_cli_phase(device, tmp, drive_dir):
    """The serving stack through the port's CLIs on the kitti phase's drive
    (KITTI_FRAMES PNGs of 1242x375 and its calib; see the module
    docstring). Prints the phase's record, then checks it."""
    t_phase = time.perf_counter()
    image_dir = os.path.join(drive_dir, "image_02", "data")
    calib_dir = os.path.dirname(drive_dir)
    config = load_config(CONFIG)
    height, width = config.image_shape
    out = {"phase": "serve_cli", "config": "configs/tpu_v5e.yaml", "height": height,
           "width": width, "precision": config.action.precision, "frames": KITTI_FRAMES}
    checks = []
    # the seeded models as a reference-schema .pth, the weights every CLI
    # below serves
    weights = os.path.join(tmp, "serve_weights.pth")
    seeded = create_train_state(config, torch.Generator().manual_seed(SEED + 13), device=device)
    export_reference_checkpoint(seeded.depth_model, seeded.pose_model, weights)
    del seeded
    torch.cuda.synchronize()
    kernels.reset_launch_counts()

    # 1. cli.pipeline, one camera, unpaced, lossless, .bin clouds (twice:
    # the first run also pays for the process's first cuDNN plans)
    base = ["--calib", calib_dir, "--config", CONFIG, "--torch-checkpoint", weights,
            "--height", str(height), "--width", str(width), "--queue-size",
            str(2 * KITTI_FRAMES), "--format", "bin"]
    one = {}
    for run in ("first", "second"):
        save = os.path.join(tmp, f"clouds_one_{run}")
        t0 = time.perf_counter()
        one[run], _ = _quiet(pipeline_cli.main, ["--images", image_dir, *base, "--save-dir", save])
        one[run]["cli_seconds"] = time.perf_counter() - t0
    files = sorted(os.listdir(save))
    clouds = [load_velo_scan(os.path.join(save, name)) for name in files]
    out["one_camera"] = dict(one, frames_per_s=one["second"]["hz"])
    checks += [
        (all(r["frames"] == KITTI_FRAMES and r["streams"] == 1 for r in one.values()),
         f"one camera: {one}"),
        (files == [f"cloud_{i:06d}.bin" for i in range(KITTI_FRAMES)], f"cloud files {files}"),
        (all(c.ndim == 2 and c.shape[1] == 4 and len(c) > 0 and np.isfinite(c).all()
             for c in clouds), "a .bin cloud does not read back as [N, 4] finite points"),
    ]

    # 2. two cameras: the drive twice, one batch-2 forward a rig step
    save2 = os.path.join(tmp, "clouds_two")
    t0 = time.perf_counter()
    two, _ = _quiet(pipeline_cli.main, ["--images", image_dir, image_dir, *base,
                                        "--save-dir", save2])
    two["cli_seconds"] = time.perf_counter() - t0
    files2 = sorted(os.listdir(save2))
    out["two_cameras"] = dict(two, rig_steps_per_s=two["hz"], frames_per_s=2 * two["hz"])
    checks += [
        (two["frames"] == KITTI_FRAMES and two["streams"] == 2, f"two cameras: {two}"),
        (files2 == [f"cloud_cam{c}_{i:06d}.bin" for c in range(2) for i in range(KITTI_FRAMES)],
         f"two-camera cloud files: {len(files2)}"),
        (all(len(load_velo_scan(os.path.join(save2, n))) > 0 for n in files2),
         "an empty two-camera cloud"),
    ]

    # 3. the in-process pipeline on the same weights and device: one
    # frame's cloud as the CLI saved it, then the latency a frame at 10 Hz
    state = create_train_state(config, torch.Generator().manual_seed(config.action.random_seed),
                               device=device)
    load_serving_weights(config, state, torch_checkpoint=weights)
    pipeline = DepthToPointCloudPipeline(
        make_depth_fn(state.depth_model, precision=config.action.precision),
        PseudoLiDAR(calib_dir, device=device), device=device)
    frame = 5
    source = FileImageSource(image_dir, size_hw=(height, width))
    in_process = pipeline.process(next(itertools.islice(iter(source), frame, None)), frame)
    same_shape = in_process.points.shape == clouds[frame].shape
    cloud_err = (float(np.abs(in_process.points - clouds[frame]).max()) if same_shape
                 else float("inf"))
    out["cloud_vs_in_process"] = {"frame": frame, "points": len(clouds[frame]),
                                  "in_process_points": len(in_process.points),
                                  "max_abs_err": cloud_err}
    checks.append((same_shape and np.allclose(in_process.points, clouds[frame],
                                              rtol=SERVE_RTOL, atol=0.0),
                   f"CLI cloud vs in-process: {out['cloud_vs_in_process']}"))

    out["paced"] = paced_latency(pipeline, image_dir, height, width)
    checks.append((out["paced"]["frames"] == len(out["paced"]["latency_ms"]) == KITTI_FRAMES,
                   f"paced run: {out['paced']}"))

    # 4. cli.inference on one frame with a .bin cloud: the in-process depth
    cloud_path = os.path.join(tmp, "inference_cloud.bin")
    depth, _ = _quiet(inference_cli.main, [
        "--config", CONFIG, "--image", os.path.join(image_dir, f"{frame:010d}.png"),
        "--torch-checkpoint", weights, "--calib", calib_dir, "--cloud", cloud_path])
    inf_cloud = load_velo_scan(cloud_path)
    depth_rel = float(np.max(np.abs(depth - in_process.depth) / in_process.depth))
    out["inference"] = {"depth_shape": list(depth.shape), "points": len(inf_cloud),
                        "depth_max_rel_err_vs_in_process": depth_rel}
    checks += [(depth.shape == (height, width) and np.isfinite(depth).all(),
                f"inference depth {depth.shape}"),
               (depth_rel <= SERVE_RTOL, f"inference depth vs in-process: rel {depth_rel}"),
               (len(inf_cloud) > 0 and np.isfinite(inf_cloud).all(), "inference cloud")]
    del state, pipeline
    release_memory()

    # 5. cli.export on basic_config (1280x384, fp32) fused with the
    # projector, batch-polymorphic, --verify; then run_exported at batch 1
    # and 2 against the live fused module
    basic = load_config(BASIC_CONFIG)
    b_height, b_width = basic.image_shape
    artifact = os.path.join(tmp, "depth_cloud.pt2")
    t0 = time.perf_counter()
    _, log = _quiet(export_cli.main, ["--config", BASIC_CONFIG, "--out", artifact,
                                      "--torch-checkpoint", weights, "--calib", calib_dir,
                                      "--batch-poly", "--verify"])
    export_s = time.perf_counter() - t0
    with open(artifact + ".json") as f:
        sidecar = json.load(f)
    state = create_train_state(basic, torch.Generator().manual_seed(basic.action.random_seed),
                               device=device)
    _quiet(load_serving_weights, basic, state, weights)  # PoseFc: a pose warning
    live = make_depth_cloud_fn(make_depth_fn(state.depth_model, precision=basic.action.precision),
                               PseudoLiDAR(calib_dir, device=device))
    gen = torch.Generator(device=device).manual_seed(SEED)
    runs, close = {}, []
    for batch in (1, 2):
        img = torch.rand(batch, b_height, b_width, 3, generator=gen, device=device) * 2 - 1
        got = run_exported(artifact, img)
        with torch.no_grad():
            want = live(img)
        runs[batch] = {"depth_max_abs_err": max_err(got[0], want[0]),
                       "points_max_abs_err": max_err(got[1], want[1]),
                       "mask_mismatch": float((got[2] != want[2]).float().mean()),
                       "valid_points": int(got[2].sum())}
        close.append(all(torch.allclose(a, b, rtol=EXPORT_TOL, atol=EXPORT_TOL)
                         for a, b in zip(got[:2], want[:2])))
    # the loaded program and the live module at batch 1, device time
    program = load_exported(artifact).module()
    img = img[:1]
    with torch.no_grad():
        program_ms = device_time_ms(lambda: program(img), calls=5, runs=3)
        live_ms = device_time_ms(lambda: live(img), calls=5, runs=3)
    out["export"] = {"config": "configs/basic_config.yaml", "height": b_height, "width": b_width,
                     "cli_seconds": export_s, "size_bytes": sidecar["size_bytes"],
                     "inputs": sidecar["inputs"], "outputs": sidecar["outputs"],
                     "device": sidecar["device"], "weights": sidecar["weights"],
                     "verify_ok": "verify OK" in log, "run_exported": runs,
                     "program_ms_batch1": program_ms, "live_ms_batch1": live_ms}
    checks += [
        ("verify OK" in log, "cli.export --verify did not report OK"),
        (sidecar["inputs"][0]["shape"] == ["b", str(b_height), str(b_width), "3"],
         f"sidecar inputs {sidecar['inputs']}"),
        (all(close) and all(r["mask_mismatch"] <= POINTS_MASK_MISMATCH and r["valid_points"] > 0
                            for r in runs.values()), f"run_exported vs live: {runs}"),
    ]
    del state, live, program
    release_memory()

    launches = dict(kernels.launch_counts)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    checks.append((launches == dict.fromkeys(kernels.KERNELS, 0),
                   f"serve launches {launches}: the serving path holds no kernel"))
    for ok, what in checks:
        check(ok, what)


def serve_graph_case(device, model, calib_dir, frames, streams, precision, metric_output):
    """One serving case of the serve_graph phase: the captured pipeline
    against an eager one on the same model and frames (cuDNN deterministic,
    set by the caller). Each pipeline's first call runs eagerly, the
    captured one's second captures; then SERVE_GRAPH_FRAMES frames (rig
    steps of `streams` cameras) each: the outputs compared uncompacted
    (depth, points, the share of mismatched valid), ms a frame by the host
    clock and by CUDA events, op_breakdown over 3 calls (busy share), graph
    launches a call, capture seconds, the graph pool's bytes and the eager
    pipeline's peak allocated bytes; and `infer` alone (the outputs on the
    host, not compacted), ms a frame by the host clock. -> (record,
    checks)."""
    def pipeline(graph):
        return DepthToPointCloudPipeline(
            make_depth_fn(model, metric_output=metric_output, precision=precision),
            PseudoLiDAR(calib_dir, device=device), device=device, graph=graph)

    captured, eager = pipeline(None), pipeline(False)
    steps = [np.stack([frames[(i + s) % len(frames)] for s in range(streams)])
             for i in range(2 + SERVE_GRAPH_FRAMES)]
    depth_err = points_err = mismatch = 0.0
    for imgs in steps:
        got, want = captured.infer(imgs), eager.infer(imgs)
        depth_err = max(depth_err, float(np.abs(got[0] - want[0]).max()))
        points_err = max(points_err, float(np.abs(got[1] - want[1]).max()))
        mismatch = max(mismatch, float(np.mean(got[2] != want[2])))
    graphs = captured.graphs
    record = {"streams": streams, "height": frames[0].shape[0], "width": frames[0].shape[1],
              "precision": precision, "metric_output": metric_output,
              "depth_max_abs_err": depth_err, "points_max_abs_err": points_err,
              "valid_mismatch_share": mismatch, "graphs": len(graphs.graphs),
              "capture_seconds": [g.seconds for g in graphs.graphs.values()],
              "pool_bytes": pool_bytes(graphs.pool),
              "valid_points_per_frame": float(got[2].sum()) / streams}

    def serve(pipe, imgs):  # one camera's process, a rig's process_batch
        return pipe.process(imgs[0]) if streams == 1 else pipe.process_batch(imgs)

    for label, pipe in (("captured", captured), ("eager", eager)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        replays = graphs.replays
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for imgs in steps[2:]:
            serve(pipe, imgs)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / SERVE_GRAPH_FRAMES
        peak = torch.cuda.max_memory_allocated()
        launches = (graphs.replays - replays) / SERVE_GRAPH_FRAMES
        t0 = time.perf_counter()
        for imgs in steps[2:]:
            pipe.infer(imgs)
        infer_ms = (time.perf_counter() - t0) * 1e3 / SERVE_GRAPH_FRAMES
        result = op_breakdown(serve, pipe, steps[0], steps=PROFILE_STEPS, warmup=1,
                              verbose=False)
        record[label] = {"ms_per_frame_host": host_ms,
                         "ms_per_frame_cuda_events": start.elapsed_time(end) / SERVE_GRAPH_FRAMES,
                         "ms_per_frame_infer_host": infer_ms,
                         "top_families_ms_per_frame": dict(list(result.items())[:6]),
                         "profiled_device_ms_per_frame": result.total_ms,
                         "profiled_device_busy_ms_per_frame": result.busy_ms,
                         "profiled_host_window_ms_per_frame": result.host_ms,
                         "busy_share": result.busy,
                         "profiled_device_events_per_frame":
                             sum(result.counts.values()) / PROFILE_STEPS,
                         "peak_allocated_bytes": peak}
        if label == "captured":
            record[label]["graph_launches_per_frame"] = launches
    record["host_ms_ratio_captured_to_eager"] = (record["captured"]["ms_per_frame_host"]
                                                 / record["eager"]["ms_per_frame_host"])
    checks = [
        (depth_err == points_err == mismatch == 0.0,
         f"serve_graph: captured vs eager depth {depth_err}, points {points_err}, "
         f"valid mismatch {mismatch}"),
        (record["captured"]["graph_launches_per_frame"] == 1.0 and len(graphs.graphs) == 1,
         f"serve_graph: {len(graphs.graphs)} graphs, "
         f"{record['captured']['graph_launches_per_frame']} launches a frame"),
    ]
    del captured, eager
    release_memory()
    return record, checks


def serve_graph_phase(device, tmp, drive_dir):
    """Serving as one program (see the module docstring's `serve_graph`).
    Prints the phase's record, then checks it."""
    t_phase = time.perf_counter()
    out, checks = {"phase": "serve_graph", "card": card(), "frames": SERVE_GRAPH_FRAMES}, []
    image_dir = os.path.join(drive_dir, "image_02", "data")
    calib_dir = os.path.dirname(drive_dir)
    kernels.reset_launch_counts()
    torch.backends.cudnn.deterministic = True
    try:
        cases = (("tpu_v5e", CONFIG, 1), ("basic_config", BASIC_CONFIG, 1),
                 ("basic_config_rig2", BASIC_CONFIG, 2), ("bts", None, 1))
        for name, path, streams in cases:
            gen = torch.Generator().manual_seed(SEED + 61)
            if path is None:  # BtsModel's metric depth, as cli.pipeline serves it
                (height, width), precision, metric = BTS_SHAPE, "fp32", True
                model_name, kwargs = BTS_CASE["depth"]
                model = build_model(model_name, gen, device=device, **kwargs)
            else:
                config = load_config(path)
                (height, width), precision, metric = (config.image_shape,
                                                      config.action.precision, False)
                model = create_train_state(config, gen, device=device).depth_model
            frames = list(FileImageSource(image_dir, size_hw=(height, width)))
            out[name], more = serve_graph_case(device, model, calib_dir, frames, streams,
                                               precision, metric)
            out[name]["config"] = os.path.relpath(path, ROOT) if path else "BtsModel 512"
            checks += more
            del model
            release_memory()

        # the pose-only eval step on the kitti drive's batches, captured
        # against eager: the PoseFc the kitti phase trained (a fresh one's
        # zero last layer gives every input the same poses)
        config = load_config(os.path.join(tmp, "kitti_config.yaml"))
        config.action.from_scratch = False
        pose = Trainer(config, device=device, graph=False).state.pose_model
        dataset = UnSupKittiDataset(config)
        batches = list(dataset.batches(list(range(len(dataset))), config.action.batch_size,
                                       KITTI_WORKERS, with_groundtruth=False))
        step, eager = make_pose_eval_step(pose, device=device), make_pose_eval_step(
            pose, device=device, graph=False)
        diffs = []
        for batch in batches:
            got, want = step(batch), eager(batch)
            diffs.append(max(float((got[k] - want[k]).abs()) for k in want))
        out["pose_eval"] = {"model": config.model.pose.name, "batches": len(batches),
                            "batch": config.action.batch_size, "max_abs_diff": diffs,
                            "metrics": {k: float(v) for k, v in got.items()},
                            "replays": step.graphs.replays,
                            "capture_seconds": [g.seconds for g in step.graphs.graphs.values()]}
        checks += [(max(diffs) == 0.0, f"serve_graph: captured pose eval step differs: {diffs}"),
                   (step.graphs.replays == len(batches) - 1,
                    f"serve_graph: pose eval replays {step.graphs.replays}")]
        del pose, step, eager
    finally:
        torch.backends.cudnn.deterministic = False
    release_memory()
    out["launches"] = dict(kernels.launch_counts)
    checks.append((out["launches"] == dict.fromkeys(kernels.KERNELS, 0),
                   f"serve_graph launches {out['launches']}: serving holds no kernel"))
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)


def _write_yaml(path, raw):
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def bts_serving_check(device, tmp, drive_dir):
    """BtsModel serving at the reference ROS node's BTS_SHAPE (batch 1,
    fp32, seeded weights) through the port's CLIs on the kitti drive: the
    ROS blob by cli.export --format bts-serving, cli.pipeline serving it
    (frames/s, the latency at 10 Hz), one frame against the in-process
    fused depth+cloud module, cli.export of the config fused with the
    projector (--verify, then run_exported against the live module), the
    forward card vs CPU, peak memory, and no launch of A, A', B or C.
    -> (record, checks)."""
    t_check = time.perf_counter()
    height, width = BTS_SHAPE
    image_dir = os.path.join(drive_dir, "image_02", "data")
    calib_dir = os.path.dirname(drive_dir)
    config_path = _write_yaml(os.path.join(tmp, "bts.yaml"), {
        "model": {"name": "bts", "depth": {"name": "BtsModel"}, "pose": {"name": "PoseNet"}},
        "datasets": {"augmentation": {"image_height": height, "image_width": width}},
        "action": {"checkpoint_dir": os.path.join(tmp, "bts_checkpoints"), "precision": "fp32"},
    })
    config = load_config(config_path)
    out = {"model": "BtsModel", "height": height, "width": width, "batch": 1,
           "precision": config.action.precision, "frames": KITTI_FRAMES}
    checks = []
    weights = os.path.join(tmp, "bts_weights.pth")
    seeded = create_train_state(config, torch.Generator().manual_seed(SEED + 19), device=device)
    out["depth_parameters"] = sum(p.numel() for p in seeded.depth_model.parameters())
    export_reference_checkpoint(seeded.depth_model, seeded.pose_model, weights)
    del seeded
    torch.cuda.synchronize()
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    # 1. the ROS node's blob
    blob = os.path.join(tmp, "bts_serving.pth")
    _, log = _quiet(export_cli.main, ["--config", config_path, "--torch-checkpoint", weights,
                                      "--out", blob, "--format", "bts-serving"])
    ros = torch.load(blob, map_location="cpu", weights_only=True)
    out["ros_blob"] = {"bytes": os.path.getsize(blob), "tensors": len(ros["model"])}
    checks.append((sorted(ros) == ["model"] and all(k.startswith("module.") for k in ros["model"])
                   and "BTS serving blob" in log, f"ROS blob {out['ros_blob']}"))

    # 2. cli.pipeline serving it, one camera, unpaced, lossless, .bin
    # clouds (twice: the first run also pays for the process's first cuDNN
    # plans at this shape)
    base = ["--images", image_dir, "--calib", calib_dir, "--config", config_path,
            "--torch-checkpoint", blob, "--height", str(height), "--width", str(width),
            "--queue-size", str(2 * KITTI_FRAMES), "--format", "bin"]
    runs = {}
    for run in ("first", "second"):
        save = os.path.join(tmp, f"bts_clouds_{run}")
        t0 = time.perf_counter()
        runs[run], log = _quiet(pipeline_cli.main, [*base, "--save-dir", save])
        runs[run]["cli_seconds"] = time.perf_counter() - t0
    files = sorted(os.listdir(save))
    clouds = [load_velo_scan(os.path.join(save, name)) for name in files]
    out["pipeline"] = dict(runs, frames_per_s=runs["second"]["hz"])
    checks += [
        (all(r["frames"] == KITTI_FRAMES for r in runs.values()), f"BTS pipeline: {runs}"),
        (f"serving BtsModel weights from {blob}" in log, "the pipeline did not serve the blob"),
        (files == [f"cloud_{i:06d}.bin" for i in range(KITTI_FRAMES)], f"BTS clouds {files}"),
        (all(len(c) > 0 and np.isfinite(c).all() for c in clouds), "an empty BTS cloud"),
    ]

    # 3. one frame against the in-process fused module of the same weights;
    # then the latency a frame at 10 Hz
    state = create_train_state(config, torch.Generator().manual_seed(SEED), device=device)
    load_serving_weights(config, state, torch_checkpoint=blob)
    model = state.depth_model.eval()
    projector = PseudoLiDAR(calib_dir, device=device)
    fused = make_depth_cloud_fn(make_depth_fn(model, metric_output=True), projector)
    frame = 5
    img = next(itertools.islice(iter(FileImageSource(image_dir, size_hw=(height, width))),
                                frame, None))
    img_t = torch.as_tensor(img[None], device=device)
    with torch.no_grad():
        depth, points, valid = fused(img_t)
    in_process = points[0][valid[0]].cpu().numpy()
    same = in_process.shape == clouds[frame].shape
    out["cloud_vs_in_process"] = {
        "frame": frame, "points": len(clouds[frame]), "in_process_points": len(in_process),
        "max_abs_err": float(np.abs(in_process - clouds[frame]).max()) if same else None,
        "depth_min_m": float(depth.min()), "depth_max_m": float(depth.max())}
    checks.append((same and np.allclose(in_process, clouds[frame], rtol=SERVE_RTOL, atol=0.0),
                   f"BTS CLI cloud vs in-process: {out['cloud_vs_in_process']}"))
    pipeline = DepthToPointCloudPipeline(make_depth_fn(model, metric_output=True), projector,
                                         device=device)
    out["paced"] = paced_latency(pipeline, image_dir, height, width)
    checks.append((out["paced"]["frames"] == KITTI_FRAMES, f"BTS paced: {out['paced']}"))
    with torch.no_grad():
        out["forward_ms_batch1"] = device_time_ms(lambda: model(img_t.permute(0, 3, 1, 2)),
                                                  calls=5, runs=3)

    # 4. cli.export of the config fused with the projector, --verify; the
    # program at batch 1 against the live module
    artifact = os.path.join(tmp, "bts_cloud.pt2")
    t0 = time.perf_counter()
    _, log = _quiet(export_cli.main, ["--config", config_path, "--out", artifact,
                                      "--torch-checkpoint", blob, "--calib", calib_dir,
                                      "--verify"])
    export_s = time.perf_counter() - t0
    with torch.no_grad():
        got = run_exported(artifact, img_t)
        want = fused(img_t)
    out["export"] = {"cli_seconds": export_s, "verify_ok": "verify OK" in log,
                     "size_bytes": os.path.getsize(artifact),
                     "depth_max_abs_err": max_err(got[0], want[0]),
                     "points_max_abs_err": max_err(got[1], want[1]),
                     "mask_mismatch": float((got[2] != want[2]).float().mean())}
    checks += [("verify OK" in log, "BTS cli.export --verify did not report OK"),
               (all(torch.allclose(a, b, rtol=EXPORT_TOL, atol=EXPORT_TOL)
                    for a, b in zip(got[:2], want[:2]))
                and out["export"]["mask_mismatch"] <= POINTS_MASK_MISMATCH,
                f"BTS run_exported vs live: {out['export']}")]
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # 5. the forward on the card vs the CPU on the same frame
    t0 = time.perf_counter()
    cpu_model = build_model("BtsModel", device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        on_gpu = model(img_t.permute(0, 3, 1, 2))
        on_cpu = cpu_model.eval()(img_t.permute(0, 3, 1, 2).cpu())
    names = ("depth_8x8", "depth_4x4", "depth_2x2", "reduc1x1", "final_depth")
    out["forward_rel_l2_cuda_vs_cpu"] = {n: rel_l2(a.cpu(), b) for n, a, b in
                                         zip(names, on_gpu, on_cpu)}
    out["final_depth_max_abs_err_cuda_vs_cpu"] = max_err(on_gpu[4].cpu(), on_cpu[4])
    checks.append((max(out["forward_rel_l2_cuda_vs_cpu"].values()) <= BTS_REL_L2,
                   f"BTS forward cuda vs cpu: {out['forward_rel_l2_cuda_vs_cpu']}"))
    del state, model, cpu_model, fused, pipeline
    release_memory()
    out["cpu_forward_seconds"] = time.perf_counter() - t0

    out["launches"] = dict(kernels.launch_counts)
    checks.append((out["launches"] == dict.fromkeys(kernels.KERNELS, 0),
                   f"BTS serving launches {out['launches']}: it holds no kernel of ops/cuda"))
    out["seconds"] = time.perf_counter() - t_check
    return out, checks


def zoo_train_check(device, tmp, name, kwargs, scales):
    """Trainer.run_epoch of configs/basic_config.yaml (1280x384, batch 4,
    fp32, 'min', PoseFc) with its depth net replaced by `name`(**kwargs),
    1 warm-up and TRAIN_STEPS timed steps: ms a step, launches against
    expected_launches for `scales` output scales, finite losses, peak
    memory, and the loss-side gradients card vs CPU on ZOO_GRAD_ROWS rows
    of a batch. -> (record, checks, the trainer)."""
    t_check = time.perf_counter()
    with open(BASIC_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["model"]["depth"] = {"name": name, **kwargs}
    raw["action"]["checkpoint_dir"] = os.path.join(tmp, "zoo_checkpoints")
    config = load_config(_write_yaml(os.path.join(tmp, f"zoo_{name}.yaml"), raw))
    batch_size = config.action.batch_size
    height, width = config.image_shape
    data = SyntheticTripletDataset(1 + TRAIN_STEPS, batch_size, height, width,
                                   seed=SEED + 23, uint8_images=True)
    batches = list(data.batches())
    losses = []
    config.action.log_freq = 1
    trainer = Trainer(config, data, log_fn=lambda m, step: losses.append(m["loss"]),
                      device=device)
    trainer.run_epoch(batches[:1] * 2)  # warm-up: cuDNN's algorithm choice, the capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses.clear()
    metrics, host_ms, event_ms, launches = timed_epoch(trainer, batches[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    grad_rel = loss_grad_rel(trainer, {k: v[:ZOO_GRAD_ROWS] for k, v in batches[1].items()})
    grad_s = time.perf_counter() - t0
    per_step = expected_launches(config.action.loss_mode, scales)
    expected = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    out = {"model": name, "kwargs": kwargs, "pose": config.model.pose.name,
           "batch": batch_size, "height": height, "width": width,
           "precision": config.action.precision, "loss_mode": config.action.loss_mode,
           "scales": scales, "steps": TRAIN_STEPS, "ms_per_step_cuda_events": event_ms,
           "ms_per_step_host": host_ms, "losses": losses, "final_metrics": metrics,
           "launches": launches, "expected_launches_per_step": per_step,
           "depth_parameters": sum(p.numel() for p in trainer.state.depth_model.parameters()),
           "loss_grad_rel_l2_cuda_vs_cpu": grad_rel, "loss_grad_rows": ZOO_GRAD_ROWS,
           "loss_grad_seconds": grad_s, "max_memory_allocated_gib": peak}
    checks = [
        (launches == expected, f"{name}: launches {launches}, expected {expected}"),
        (len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), f"{name}: losses {losses}"),
        (max(grad_rel.values()) <= GRAD_REL_L2,
         f"{name}: loss gradients cuda vs cpu: rel L2 {grad_rel} > {GRAD_REL_L2}"),
    ]
    out["seconds"] = time.perf_counter() - t_check
    return out, checks, trainer


def models_phase(device, tmp, drive_dir):
    """The rest of the model zoo on the card: BtsModel serving at
    BTS_SHAPE (bts_serving_check), a training step of each multi-scale or
    transformer depth net at basic_config's shape (zoo_train_check), and
    PoseDecoder over ResNet-50 encoder features card vs CPU. Prints the
    phase's record, then checks it."""
    t_phase = time.perf_counter()
    out = {"phase": "models"}
    out["bts_serving"], checks = bts_serving_check(device, tmp, drive_dir)
    out["train"] = {}
    for name, kwargs, scales in ZOO_TRAIN:
        record, more, trainer = zoo_train_check(device, tmp, name, kwargs, scales)
        out["train"][record["model"] + ("-stn" if kwargs.get("use_stn") else "")
                     + (f"-{kwargs['num_layers']}" if "num_layers" in kwargs else "")] = record
        checks += more
        if name == "DispResNet":
            out["pose_decoder"] = pose_decoder_check(trainer, device)
            checks.append((out["pose_decoder"]["max_abs_err_cuda_vs_cpu"] <= POSE_DECODER_ATOL,
                           f"PoseDecoder cuda vs cpu: {out['pose_decoder']}"))
        del trainer
        release_memory()
    out["determinism"], more = determinism_check(device)
    checks += more
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)


def repeat_step(device, overrides):
    """Two eager train steps of basic_config with spatial_setup's
    `overrides` from one state (the parameters and BatchNorm statistics
    loaded anew before each; the step's inputs made once), under cuDNN
    deterministic; then a third under
    torch.use_deterministic_algorithms(True, warn_only=True), whose
    warnings name the ops that have no deterministic CUDA version.
    -> record."""
    t0 = time.perf_counter()
    config, (batch,) = spatial_setup(BASIC_CONFIG, overrides, 1)
    trainer = Trainer(config, device=device, graph=False)
    step = trainer.train_step
    inputs = step.inputs(batch, 0)
    start = {name: {k: v.clone() for k, v in getattr(trainer.state, name).state_dict().items()}
             for name in ("depth_model", "pose_model")}

    def run():
        for name, state in start.items():
            getattr(trainer.state, name).load_state_dict(state)
        metrics = step.body(inputs)
        return ({k: float(v) for k, v in metrics.items()},
                {**_named(trainer, "grads"), **_named(trainer, "stats")})

    torch.backends.cudnn.deterministic = True
    try:
        (loss_a, a), (loss_b, b) = run(), run()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                run()
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        torch.backends.cudnn.deterministic = False
    diffs = {k: max_err(a[k], v) if v.numel() else 0.0 for k, v in b.items()}
    differing = sorted((k for k, d in diffs.items() if d), key=diffs.get, reverse=True)
    warned = sorted({str(w.message).split(". ")[0][:160] for w in caught})
    del trainer
    release_memory()
    return {"height": config.image_shape[0], "width": config.image_shape[1],
            "batch": config.action.batch_size, "leaves": len(diffs),
            "gradient_leaves": sum(not k.endswith(("running_mean", "running_var"))
                                   for k in diffs),
            "max_abs_diff": max(diffs.values()), "differing_leaves": len(differing),
            "worst_leaves": {k: diffs[k] for k in differing[:5]},
            "loss_abs_diff": max(abs(loss_a[k] - loss_b[k]) for k in loss_a),
            "nondeterministic_ops_warned": warned, "seconds": time.perf_counter() - t0}


def resize_repeat(fn, x, g):
    """The gradient of sum(fn(x) · g) w.r.t. x (ops/resample's resize)
    twice on the card and once on the CPU -> (max abs difference of the two
    card runs, of the card's against the CPU's, the autograd call's ms by
    device_time_ms, which the host's work a call bounds)."""
    leaf = x.clone().requires_grad_()
    out = fn(leaf)

    def grad():
        return torch.autograd.grad(out, leaf, g, retain_graph=True)[0]

    first, second = grad(), grad()
    cpu_leaf = x.cpu().requires_grad_()
    (on_cpu,) = torch.autograd.grad(fn(cpu_leaf), cpu_leaf, g.cpu())
    return max_err(first, second), max_err(first.cpu(), on_cpu), device_time_ms(grad)


def graph_ms(fn):
    """Device ms of one call of fn replayed from a CUDA graph: the host's
    launches left out, as in a captured step (device_time_ms of the
    replay)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = device_time_ms(graph.replay)
    del graph
    return ms


def determinism_check(device):
    """Does a training step repeat on the card? repeat_step for each of
    DETERMINISM_CASES (every gradient leaf, the loss and the BatchNorm
    statistics of two runs required equal), and the resizes' gradients
    alone: resize_bilinear at the loss's shapes and resize_nearest at
    BtsModel's, twice on the card and on the CPU (required equal bit for
    bit); resize_bilinear_grad timed beside torch's
    upsample_bilinear2d_backward, each replayed from a CUDA graph (`ms`,
    `library_ms`) and eagerly (`eager_ms`, `library_eager_ms`), and the
    two runs of torch's on the same input compared. -> (record, checks)."""
    t_check = time.perf_counter()
    out = {"steps": {name: repeat_step(device, overrides)
                     for name, overrides in DETERMINISM_CASES}}
    checks = [(r["max_abs_diff"] == 0.0 and r["loss_abs_diff"] == 0.0,
               f"determinism: two steps of {name} from one state differ: {r}")
              for name, r in out["steps"].items()]
    gen = torch.Generator().manual_seed(SEED + 29)
    height, width = 384, 1280
    out["resize_bilinear"] = {}
    for s in RESIZE_SCALES:
        shape = (4, 1, height >> s, width >> s)
        x = (torch.rand(shape, generator=gen) + 0.1).to(device)
        g = torch.randn(4, 1, height, width, generator=gen).to(device)
        repeat, vs_cpu, ms = resize_repeat(lambda t: resize_bilinear(t, height, width), x, g)

        def port():
            return resize_bilinear_grad(g, *shape[2:], torch.float32)

        def library():
            return torch.ops.aten.upsample_bilinear2d_backward(
                g, [height, width], list(shape), False)

        out["resize_bilinear"][f"s{s}"] = {
            "coarse": list(shape), "out": [height, width], "repeat_max_abs_diff": repeat,
            "cuda_vs_cpu_max_abs_diff": vs_cpu, "autograd_ms": ms,
            "ms": graph_ms(port), "library_ms": graph_ms(library),
            "eager_ms": device_time_ms(port), "library_eager_ms": device_time_ms(library),
            "library_repeat_max_abs_diff": max_err(library(), library())}
        checks.append((repeat == 0.0 and vs_cpu == 0.0,
                       f"determinism: resize_bilinear's gradient at {shape}: "
                       f"{out['resize_bilinear'][f's{s}']}"))
    out["resize_nearest"] = {}
    x = (torch.rand(1, 1, *BTS_SHAPE, generator=gen) + 0.1).to(device)
    for f in NEAREST_FACTORS:
        size = (BTS_SHAPE[0] // f, BTS_SHAPE[1] // f)
        g = torch.randn(1, 1, *size, generator=gen).to(device)
        repeat, vs_cpu, ms = resize_repeat(lambda t: resize_nearest(t, *size), x, g)
        out["resize_nearest"][f"x{f}"] = {"repeat_max_abs_diff": repeat,
                                          "cuda_vs_cpu_max_abs_diff": vs_cpu, "ms": ms}
        checks.append((repeat == 0.0 and vs_cpu == 0.0,
                       f"determinism: resize_nearest's gradient /{f}: "
                       f"{out['resize_nearest'][f'x{f}']}"))
    out["seconds"] = time.perf_counter() - t_check
    return out, checks


def models_only(device="cuda:0"):
    """The kernels' build and the models phase alone (python3
    chip_smoke.py --models), on a KITTI-shaped drive written to a temp
    dir."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0), "nvidia_smi": card(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    build.build_all()
    build.load_libraries()
    with tempfile.TemporaryDirectory() as tmp:
        _, _, drive_dir = write_kitti_drive(os.path.join(tmp, "data"))
        models_phase(device, tmp, drive_dir)


def pose_decoder_check(trainer, device):
    """PoseDecoder (seeded, ResNet-50 widths) over the encoder features of
    a trained DispResNet-50's target and first reference frames, on the
    card and on the CPU."""
    encoder = trainer.state.depth_model.encoder.eval()
    batch = normalize_uint8_batch(batch_to_device(
        next(SyntheticTripletDataset(1, 2, *trainer.config.image_shape, seed=SEED + 29,
                                     uint8_images=True).batches()), device))
    decoder = build_model("PoseDecoder", torch.Generator().manual_seed(SEED), device=device,
                          num_ch_enc=encoder.num_ch_enc)
    cpu_decoder = build_model("PoseDecoder", device="cpu", num_ch_enc=encoder.num_ch_enc)
    cpu_decoder.load_state_dict(decoder.state_dict())
    with torch.no_grad():
        feats = [encoder(batch["tgt"]), encoder(batch["ref_imgs"][:, 0])]
        on_gpu = decoder(feats)
        on_cpu = cpu_decoder([[f.cpu() for f in frame] for frame in feats])
    return {"num_ch_enc": list(encoder.num_ch_enc),
            "feature_shapes": [list(f.shape) for f in feats[0]],
            "axisangle_shape": list(on_gpu[0].shape),
            "max_abs_err_cuda_vs_cpu": max(max_err(a.cpu(), b) for a, b in zip(on_gpu, on_cpu)),
            "translation_max_abs": float(on_cpu[1].abs().max())}


def event_ms_per_step(fn, steps=PROFILE_STEPS):
    """CUDA events around `steps` back-to-back calls of fn, after one more
    call: device ms a call (the host's work overlaps the card's)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def breakdown_record(result, loss_mode, steps, kernel_records=None):
    """The record of one op_breakdown of `steps` training steps, and its
    checks: each kernel present, launched as often as expected_launches
    says, and a positive device time no longer than the host window."""
    per_step = expected_launches(loss_mode)
    conv = {f: ms for f, ms in result.items() if any(w in f for w in CONV_WORDS)}
    record = {
        "steps": steps, "families": len(result),
        "top_families_ms_per_step": dict(list(result.items())[:20]),
        "device_ms_per_step": result.total_ms, "device_busy_ms_per_step": result.busy_ms,
        "host_ms_per_step": result.host_ms,
        "device_events_per_step": sum(result.counts.values()) / steps,
        "busy_share": result.busy, "conv_families_ms_per_step": sum(conv.values()),
        "conv_families": sorted(conv), "kernels": {},
    }
    checks = [(result.on_device and 0 < result.busy_ms <= result.host_ms,
               f"device busy {result.busy_ms} ms/step vs host window {result.host_ms}")]
    for name, family in PROFILED_FAMILY.items():
        k = {"family": family, "ms_per_step": result.get(family),
             "launches": result.counts.get(family), "expected": steps * per_step[name]}
        if kernel_records is not None:
            k["kernel_phase_ms"] = kernel_records[name]["ms"]
        record["kernels"][name] = k
        checks.append((k["launches"] == k["expected"] and (k["ms_per_step"] or 0) > 0,
                       f"profiled {family}: {k}"))
    return record, checks


def profile_phase(device, tmp, kitti, records_1280):
    """torch.profiler's view of the training step (see the docstring's
    `profile`). Prints the phase's record, then checks it; returns
    {config: {kernel: {ms_per_step, launches}}} for the kernels record."""
    t_phase = time.perf_counter()
    out, checks = {"phase": "profile", "steps": PROFILE_STEPS,
                   "warmup": PROFILE_WARMUP}, []

    def device_batch(config, seed):
        batch = next(SyntheticTripletDataset(1, config.action.batch_size, *config.image_shape,
                                             seed=seed, uint8_images=True).batches())
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    def profile(trainer, batch):
        print(f"[profile] {trainer.config.model.name}, cudnn.allow_tf32="
              f"{torch.backends.cudnn.allow_tf32}", flush=True)
        return op_breakdown(lambda: trainer.train_step(batch), steps=PROFILE_STEPS,
                            warmup=PROFILE_WARMUP)

    # 1. basic_config, TF32 off; then the same step with cuDNN's TF32 on
    config = load_config(BASIC_CONFIG)
    config.action.checkpoint_dir = os.path.join(tmp, "profile_checkpoints")
    trainer = Trainer(config, device=device)
    batch = device_batch(config, SEED + 13)
    result = profile(trainer, batch)
    out["basic_config"], more = breakdown_record(result, config.action.loss_mode,
                                                 PROFILE_STEPS, records_1280)
    out["basic_config"]["ms_per_step_cuda_events"] = event_ms_per_step(
        lambda: trainer.train_step(batch))
    checks += more
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        result = profile(trainer, batch)
        tf32, _ = breakdown_record(result, config.action.loss_mode, PROFILE_STEPS)
        tf32["ms_per_step_cuda_events"] = event_ms_per_step(lambda: trainer.train_step(batch))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    out["basic_config_tf32"] = {k: tf32[k] for k in (
        "device_ms_per_step", "device_busy_ms_per_step", "host_ms_per_step",
        "device_events_per_step", "busy_share", "ms_per_step_cuda_events",
        "conv_families_ms_per_step", "conv_families", "top_families_ms_per_step")}

    # 2. Trainer.log_warps on one basic_config batch: kernel A once
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    paths = trainer.log_warps(batch, step=trainer.state.step,
                              out_dir=os.path.join(tmp, "images"))
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    shapes = {name: list(np.asarray(Image.open(path)).shape) for name, path in paths.items()}
    out["log_warps"] = {"files": sorted(paths), "shapes": shapes, "launches": launches}
    height, width = config.image_shape
    checks += [
        (len(paths) == 3 and all(s == [height, width, 3] for s in shapes.values()),
         f"log_warps wrote {shapes}"),
        (launches == {"warp_bilinear_fwd": 1, "warp_bilinear_bwd": 0, "ssim_fwd": 0,
                      "ssim_bwd": 0}, f"log_warps launches {launches}"),
    ]
    del trainer, batch
    release_memory()

    # 3. tpu_v5e (bf16 models)
    config = load_config(CONFIG)
    config.action.checkpoint_dir = os.path.join(tmp, "profile_checkpoints")
    trainer = Trainer(config, device=device)
    batch = device_batch(config, SEED + 17)
    result = profile(trainer, batch)
    out["tpu_v5e"], more = breakdown_record(result, config.action.loss_mode, PROFILE_STEPS)
    out["tpu_v5e"]["ms_per_step_cuda_events"] = event_ms_per_step(
        lambda: trainer.train_step(batch))
    checks += more
    del trainer, batch
    release_memory()

    # 4. cli.train --op-breakdown --profile on the kitti drive (1 epoch):
    # the fit's trace, and the breakdown of the KITTI step (jitter, flips)
    trace_dir = os.path.join(tmp, "kitti_trace")
    steps, val_batches = kitti["train"]["steps"], kitti["train"]["val_batches"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, log = _quiet(train_cli.main, ["--config", os.path.join(tmp, "kitti_config.yaml"),
                                           "--epochs", "1", "--op-breakdown",
                                           "--profile", trace_dir])
    cli_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    result = trainer.op_breakdown
    per_step, per_val = expected_launches("min"), {"warp_bilinear_fwd": 1, "ssim_fwd": 2}
    fit_launches = {k: launches[k] - (PROFILE_WARMUP + PROFILE_STEPS) * per_step[k]
                    for k in per_step}
    expected_fit = {k: steps * per_step[k] + val_batches * per_val.get(k, 0)
                    for k in per_step}
    path = newest_trace(trace_dir)
    fit_rows = summarize_trace(path) if path else []
    fit_counts = {fam: n for fam, _, n in fit_rows}
    record, more = breakdown_record(result, "min", PROFILE_STEPS)
    out["kitti_cli"] = {
        "cli_seconds": cli_s, "fit_steps": steps, "fit_val_batches": val_batches,
        "trace_file": os.path.basename(path) if path else None,
        "trace_bytes": os.path.getsize(path) if path else 0,
        "fit_trace_device_ms": sum(ms for _, ms, _ in fit_rows),
        "fit_trace_kernel_launches": {k: fit_counts.get(f) for k, f in PROFILED_FAMILY.items()},
        "fit_wrapper_launches": fit_launches,
        "kitti_step_device_ms": result.total_ms,
        "kitti_step_host_window_ms": result.host_ms,
        "kitti_steady_ms_per_step": kitti["ms_per_step"],
        **{k: record[k] for k in ("busy_share", "conv_families_ms_per_step", "kernels")},
        "top_families_ms_per_step": dict(list(result.items())[:10]),
    }
    checks += more + [
        (path is not None and path.endswith(".pt.trace.json"), f"no trace in {trace_dir}"),
        (fit_launches == expected_fit, f"fit launches {fit_launches}, expected {expected_fit}"),
        (all(fit_counts.get(f) == fit_launches[k] for k, f in PROFILED_FAMILY.items()),
         f"the fit's trace counts {out['kitti_cli']['fit_trace_kernel_launches']}"),
        ("[trace] device time by op family" in log, "cli.train printed no breakdown"),
    ]
    del trainer
    release_memory()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)
    return {name: out[name]["kernels"] for name in ("basic_config", "tpu_v5e")}


def _graph_state(trainer):
    """A Trainer's parameters, parameter gradients, BatchNorm running
    statistics and Adam moments, by name."""
    out = _named(trainer, "params")
    out.update({f"grad.{k}": v for k, v in _named(trainer, "grads").items()})
    out.update({f"stat.{k}": v for k, v in _named(trainer, "stats").items()})
    for i, slots in trainer.state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v.detach().to("cpu", copy=True)
                    for k, v in slots.items() if k in ("exp_avg", "exp_avg_sq")})
    return out


def _worst_rel(a, b, prefixes=None):
    """(worst rel L2, its key, max abs difference) of two _graph_state
    dicts over the keys with one of `prefixes` (all keys by default)."""
    worst, key, diff = 0.0, None, 0.0
    for k, v in b.items():
        if prefixes is not None and not k.startswith(prefixes):
            continue
        d = float((a[k].double() - v.double()).abs().max()) if v.numel() else 0.0
        norm = float(torch.linalg.vector_norm(v.double()))
        rel = (float(torch.linalg.vector_norm(a[k].double() - v.double())) / norm if norm
               else d)
        diff = max(diff, d)
        if rel > worst or key is None:
            worst, key = rel, k
    return worst, key, diff


def graph_compare(config, batches, device):
    """The captured Trainer against one with graph=False from the same
    seed (cuDNN deterministic, set by the caller), on `batches`: the
    eager trainer first (its state after each step kept on the host, then
    the trainer freed: at basic_config one captured step's graph pool and
    an eager step's cache do not fit the card beside another trainer),
    then the captured one, whose first call of the signature runs eagerly,
    its second captures and the others replay. Then the eval step on the
    captured trainer's modules (its train graphs freed first), captured
    against eager. -> (record, checks)."""
    eager = Trainer(config, device=device, graph=False)
    want = []
    for batch in batches:
        metrics = eager.train_step(batch)
        want.append((float(metrics["loss"]), _graph_state(eager)))
    del eager, metrics
    release_memory()
    captured = Trainer(config, device=device)
    losses, kept = [], None
    for i, batch in enumerate(batches):
        got = captured.train_step(batch)
        losses.append((float(got["loss"]), want[i][0]))
        if i == 0:
            warm = _worst_rel(_graph_state(captured), want[0][1])
        if i == 1:
            first = {"loss_abs_diff": abs(losses[1][0] - losses[1][1]),
                     "grad_max_abs_diff": _worst_rel(_graph_state(captured), want[1][1],
                                                     ("grad.",))[2]}
            kept, kept_values = got, {k: v.clone() for k, v in got.items()}
    after = _worst_rel(_graph_state(captured), want[-1][1],
                       ("depth.", "pose.", "stat.", "adam."))
    later_loss_rel = max(abs(g - w) / abs(w) for g, w in losses[2:])
    graphs = captured.train_step.graphs
    record = {"warmup_state_worst_rel_l2": warm[0], "first_captured_step": first,
              "losses_captured_vs_eager": losses, "later_losses_max_rel": later_loss_rel,
              "state_after_worst_rel_l2": after[0], "state_after_worst_key": after[1],
              "state_after_max_abs_diff": after[2], "graphs": len(graphs.graphs),
              "replays": graphs.replays,
              "train_pool_bytes_deterministic": pool_bytes(graphs.pool)}
    checks = [
        (warm[0] == 0.0, f"graph: the eager first steps differ: {warm}"),
        (first["loss_abs_diff"] == 0.0 and first["grad_max_abs_diff"] == 0.0,
         f"graph: the first captured step differs from the eager one: {first}"),
        (later_loss_rel <= GRAPH_REL_L2 and after[0] <= GRAPH_REL_L2,
         f"graph: captured vs eager after {len(losses)} steps: {record}"),
        (len(graphs.graphs) == 1 and graphs.replays == len(batches) - 1,
         f"graph: {len(graphs.graphs)} graphs, {graphs.replays} replays"),
        (all(torch.equal(kept[k], v) for k, v in kept_values.items()),
         "graph: a later step overwrote the metrics a step returned"),
    ]

    graphs.reset()
    release_memory()
    eval_kwargs = dict(loss_mode=config.action.loss_mode, depth_norm=config.action.depth_norm,
                       precision=config.action.precision, eval_protocol="eigen",
                       pose_metrics=True, device=device)
    state = captured.state
    eval_captured = make_eval_step(state.depth_model, state.pose_model, **eval_kwargs)
    eval_eager = make_eval_step(state.depth_model, state.pose_model, graph=False,
                                **eval_kwargs)
    diffs = []
    for batch in batches:
        (got, got_depth), (want_metrics, want_depth) = eval_captured(batch), eval_eager(batch)
        diffs.append(max([float((got[k] - want_metrics[k]).abs()) for k in want_metrics]
                         + [float((got_depth - want_depth).abs().max())]))
    record["eval_max_abs_diff"] = diffs
    record["eval_replays"] = eval_captured.graphs.replays
    record["eval_pool_bytes_deterministic"] = pool_bytes(eval_captured.graphs.pool)
    checks += [(max(diffs) == 0.0, f"graph: captured eval step differs: {diffs}"),
               (eval_captured.graphs.replays == len(batches) - 1,
                f"graph: eval replays {eval_captured.graphs.replays}")]
    return record, checks


def graph_timing(config, device, batch, graph, mesh=None):
    """A Trainer's train step (captured when `graph` is None, eager when
    False; under `mesh` when given) on one device batch, after 2 warm-up
    calls: host ms a step
    (GRAPH_TIMED_STEPS steps, host clock to a synchronize), CUDA-event ms
    a step, op_breakdown over PROFILE_STEPS steps (device ms, host window,
    busy share), graph launches a step, capture seconds, the graph pool's
    bytes and the peak memory of a step."""
    trainer = Trainer(config, device=device, graph=graph, mesh=mesh)
    step = lambda: trainer.train_step(batch)  # noqa: E731
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    graphs = trainer.train_step.graphs
    replays = graphs.replays if graphs else 0
    t0 = time.perf_counter()
    for _ in range(GRAPH_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_TIMED_STEPS
    launches = ((graphs.replays - replays) / GRAPH_TIMED_STEPS) if graphs else None
    event_ms = event_ms_per_step(step)
    result = op_breakdown(step, steps=PROFILE_STEPS, warmup=1, verbose=False)
    record = {"ms_per_step_host": host_ms, "ms_per_step_cuda_events": event_ms,
              "profiled_device_ms_per_step": result.total_ms,
              "profiled_device_busy_ms_per_step": result.busy_ms,
              "profiled_host_window_ms_per_step": result.host_ms,
              "busy_share": result.busy,
              "profiled_device_events_per_step": sum(result.counts.values()) / PROFILE_STEPS,
              "graph_launches_per_step": launches,
              "capture_seconds": ([g.seconds for g in graphs.graphs.values()] if graphs
                                  else None),
              "pool_bytes": pool_bytes(graphs.pool) if graphs else None,
              "peak_allocated_bytes": peak}
    del trainer, step
    release_memory()
    return record


def graph_multi_step(device):
    """make_multi_step(num_steps=GRAPH_MULTI) on tpu_v5e against the
    captured single step from the same seed (cuDNN deterministic, set by
    the caller): 3 rounds of GRAPH_MULTI steps (the multi-step's first call
    runs eagerly, its second captures, its third replays), the states
    compared after each; then one replay of the multi-step against
    GRAPH_MULTI single replays, by host clock and CUDA events.
    -> (record, checks)."""
    config = load_config(CONFIG)
    batch_size, (height, width) = config.action.batch_size, config.image_shape
    batches = list(SyntheticTripletDataset(4 * GRAPH_MULTI, batch_size, height, width,
                                           seed=SEED + 53, uint8_images=True).batches())
    single, owner = Trainer(config, device=device), Trainer(config, device=device)
    multi = make_multi_step(owner.state, GRAPH_MULTI, device=device,
                            **{k: getattr(owner.train_step, k) for k in STEP_ARGS})

    def stacked(chunk):
        return {k: np.stack([b[k] for b in chunk]) for k in chunk[0]}

    rounds = []
    for r in range(3):
        chunk = batches[r * GRAPH_MULTI:(r + 1) * GRAPH_MULTI]
        for batch in chunk:
            want = single.train_step(batch)
        got = multi(stacked(chunk))
        rel, key, diff = _worst_rel(_graph_state(owner), _graph_state(single),
                                    ("depth.", "pose.", "stat.", "adam."))
        rounds.append({"state_worst_rel_l2": rel, "worst_key": key, "max_abs_diff": diff,
                       "loss": float(got["loss"]), "loss_single": float(want["loss"])})
    graphs = multi.train_step.graphs
    record = {"num_steps": GRAPH_MULTI, "rounds": rounds, "graphs": len(graphs.graphs),
              "replays": graphs.replays, "single_replays": single.train_step.graphs.replays,
              "capture_seconds": [g.seconds for g in graphs.graphs.values()],
              "pool_bytes": pool_bytes(graphs.pool), "step": owner.state.step}
    checks = [
        (all(r["state_worst_rel_l2"] <= GRAPH_REL_L2 and r["loss"] == r["loss_single"]
             for r in rounds), f"graph: multi-step vs single steps: {rounds}"),
        (len(graphs.graphs) == 1 and graphs.replays == 2
         and owner.state.step == single.state.step == 3 * GRAPH_MULTI,
         f"graph: multi-step {len(graphs.graphs)} graphs, {graphs.replays} replays, "
         f"step {owner.state.step}"),
    ]

    chunk = batches[3 * GRAPH_MULTI:]
    inputs = stacked(chunk)
    for label, run in (("single_replays", lambda: [single.train_step(b) for b in chunk]),
                       ("one_multi_replay", lambda: multi(inputs))):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        record[label] = {"host_ms": (time.perf_counter() - t0) * 1e3,
                         "cuda_event_ms": start.elapsed_time(end)}
    checks.append((graphs.replays == 3, f"graph: multi-step replays {graphs.replays}"))
    del single, owner, multi
    release_memory()
    return record, checks


def graph_phase(device):
    """The step as one program (see the module docstring's `graph`).
    Prints the phase's record, then checks it."""
    t_phase = time.perf_counter()
    out, checks = {"phase": "graph", "card": card()}, []
    cases = (("tpu_v5e", CONFIG, False), ("basic_config", BASIC_CONFIG, False),
             ("basic_config_tf32", BASIC_CONFIG, True))
    for name, path, tf32 in cases:
        config = load_config(path)
        batch_size, (height, width) = config.action.batch_size, config.image_shape
        record = {"batch": batch_size, "height": height, "width": width,
                  "precision": config.action.precision, "cudnn_allow_tf32": tf32}
        batches = list(SyntheticTripletDataset(2 + GRAPH_STEPS, batch_size, height, width,
                                               seed=SEED + 51, uint8_images=True).batches())
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            if not tf32:
                torch.backends.cudnn.deterministic = True
                try:
                    record["captured_vs_eager"], more = graph_compare(
                        config, batches[:1 + GRAPH_STEPS], device)
                finally:
                    torch.backends.cudnn.deterministic = False
                checks += more
                release_memory()
            batch = {k: torch.as_tensor(v).to(device) for k, v in batches[-1].items()}
            for label, graph in (("captured", None), ("eager", False)):
                record[label] = graph_timing(config, device, batch, graph)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        cap, eag = record["captured"], record["eager"]
        record["host_ms_ratio_captured_to_eager"] = (cap["ms_per_step_host"]
                                                     / eag["ms_per_step_host"])
        checks.append((cap["graph_launches_per_step"] == 1.0,
                       f"graph: {name} graph launches a step {cap['graph_launches_per_step']}"))
        out[name] = record
    torch.backends.cudnn.deterministic = True
    try:
        out["multi_step"], more = graph_multi_step(device)
    finally:
        torch.backends.cudnn.deterministic = False
    checks += more
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)


def toy_timing(device, steps):
    """The toy problem's captured step (toy_problem's own seams) on one
    batch: host ms and CUDA-event ms a step after the eager first call
    and the capture, and its graph launches a step."""
    config = toy_problem.toy_config()
    state = create_train_state(config, torch.Generator().manual_seed(0), device=device)
    step = toy_problem.make_toy_step(state, device)
    batch = toy_problem.toy_batch(config.action.batch_size, *config.image_shape, seed=0,
                                  scene_depth=10.0, cam_tx=0.01)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    replays = step.graphs.replays
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        step(batch)
    end.record()
    torch.cuda.synchronize()
    return {"steps": steps, "ms_per_step_host": (time.perf_counter() - t0) * 1e3 / steps,
            "ms_per_step_cuda_events": start.elapsed_time(end) / steps,
            "graph_launches_per_step": (step.graphs.replays - replays) / steps}


def _turntable_fixture():
    """tests/torch_turntable_fixture.py, which writes a stand-in for the
    turntable's data tree (the examples' tests write it too), loaded from
    its file."""
    spec = importlib.util.spec_from_file_location(
        "torch_turntable_fixture", os.path.join(ROOT, "tests", "torch_turntable_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def toy_replica(device, graph):
    """toy_problem.run at its defaults through the module's seams
    (toy_config, make_toy_step, toy_batch, depth_error), its step captured
    (`graph` True: the default on the card) or eager (the step's graphs
    dropped) -> (the depth errors run returns, every step's loss, the
    nets' parameters and buffers and Adam's moments at the end, on the
    host)."""
    config = toy_problem.toy_config()
    batch, (height, width) = config.action.batch_size, config.image_shape
    state = create_train_state(config, torch.Generator().manual_seed(0),
                               steps_per_epoch=TOY_STEPS, device=device)
    step = toy_problem.make_toy_step(state, device)
    if not graph:
        step.graphs = None
    errors, losses = [], []
    for i in range(TOY_STEPS):
        data = toy_problem.toy_batch(batch, height, width, i, 10.0, 0.01)
        losses.append(step(data)["loss"])
        if i == 0 or (i + 1) % max(TOY_STEPS // 10, 1) == 0:
            errors.append(toy_problem.depth_error(state.depth_model, data, 10.0, device))
    final = {f"{name}.{k}": v.detach().to("cpu", copy=True)
             for name, net in (("depth", state.depth_model), ("pose", state.pose_model))
             for k, v in net.state_dict().items()}
    for i, slots in state.optimizer.state_dict()["state"].items():
        final.update({f"adam.{i}.{k}": v.detach().to("cpu", copy=True)
                      for k, v in slots.items() if k in ("exp_avg", "exp_avg_sq")})
    return errors, torch.stack(losses).cpu(), final


def examples_phase(device):
    """The examples' counterparts on the card (see the module docstring's
    `examples`). Prints the phase's record, then checks it; returns the
    launches of A, A', B and C of the toy run and the turntable run."""
    t_phase = time.perf_counter()
    out, checks = {"phase": "examples", "card": card()}, []
    mean_step = expected_launches("mean")

    # the toy problem at its script's size: 200 captured steps, with cuDNN
    # deterministic. Its disparity collapses to 0 after the first fall
    # (error 90 m), as the JAX script's does on the CPU
    # (tests/test_torch_examples.py's slow test prints both): the script's
    # verdict is printed, not required, and the run ends at that fixed
    # point whatever the replays did on the way. Held: the captured run
    # against the same run eager on the card, bit for bit at every step
    # (losses, depth errors, parameters, buffers, Adam's moments), and its
    # first step against the same step on the CPU
    torch.backends.cudnn.deterministic = True
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        errors = toy_problem.run(steps=TOY_STEPS, verbose=False, device=device)
        torch.cuda.synchronize()
        toy_launches = dict(kernels.launch_counts)
        toy_s = time.perf_counter() - t0
        captured = toy_replica(device, graph=True)
        eager = toy_replica(device, graph=False)
    finally:
        torch.backends.cudnn.deterministic = False
    differ = (_first_difference({"loss": captured[1], **captured[2]},
                                {"loss": eager[1], **eager[2]})
              or (None if captured[0] == eager[0] == errors
                  else f"depth errors: run {errors}, captured {captured[0]}, "
                       f"eager {eager[0]}"))
    cpu_first = toy_problem.run(steps=1, verbose=False, device="cpu")[0]
    first_rel = abs(errors[0] - cpu_first) / cpu_first
    out["toy"] = {"steps": TOY_STEPS, "batch": 4, "height": 64, "width": 96,
                  "seconds": toy_s, "depth_errors_m": errors,
                  "improved": errors[-1] < errors[0],
                  "captured_vs_eager_differ": differ,
                  "losses_first_last": [float(captured[1][0]), float(captured[1][-1])],
                  "first_step_error_cpu": cpu_first, "first_step_rel": first_rel,
                  "launches": toy_launches,
                  "launches_per_step": {k: v / TOY_STEPS for k, v in toy_launches.items()},
                  "timed": toy_timing(device, EXAMPLE_TIMED_STEPS)}
    checks += [
        (all(np.isfinite(errors)), f"examples: the toy problem's depth errors: {errors}"),
        (differ is None,
         f"examples: the toy's captured run differs from the eager one: {differ}"),
        (first_rel <= TOY_FIRST_RTOL,
         f"examples: the toy's first step card {errors[0]} vs CPU {cpu_first}"),
        (toy_launches == {k: TOY_STEPS * v for k, v in mean_step.items()},
         f"examples: toy launches {toy_launches}, expected {mean_step} a step"),
        (out["toy"]["timed"]["graph_launches_per_step"] == 1.0,
         f"examples: toy graph launches a step {out['toy']['timed']}"),
    ]

    # the turntable at its script's size, on a synthetic stand-in tree
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = _turntable_fixture().write_synthetic_turntable(os.path.join(tmp, "dino"))
        write_s = time.perf_counter() - t0
        data = dino_turntable.load_dino(*DINO_SIZE, root)
        first = data["tgt"][:DINO_BATCH].astype(np.float64) / 255.0
        identity = float(np.abs(first - data["ref_imgs"][:DINO_BATCH, 0] / 255.0).mean())
        real_root = dino_turntable.DINO_ROOT
        dino_turntable.DINO_ROOT = root
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            err0, err1, curve = dino_turntable.run(steps=DINO_STEPS, batch=DINO_BATCH,
                                                   height=DINO_SIZE[0], width=DINO_SIZE[1],
                                                   verbose=False, trajectory=True,
                                                   device=device)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            dino_launches = dict(kernels.launch_counts)
            # the skip: a data root that does not exist (here, whatever
            # the machine around holds)
            dino_turntable.DINO_ROOT = os.path.join(tmp, "missing")
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                skipped = dino_turntable.run(device=device)
        finally:
            dino_turntable.DINO_ROOT = real_root
    # A once a step and once a warp_err (step 0, every 100, the end)
    evals = DINO_STEPS // 100 + 2
    expected = {k: DINO_STEPS * v + (evals if k == "warp_bilinear_fwd" else 0)
                for k, v in mean_step.items()}
    out["dino"] = {"frames": 36, "source_frame": [576, 720], "write_seconds": write_s,
                   "triplets": int(len(data["tgt"])), "batch": DINO_BATCH,
                   "height": DINO_SIZE[0], "width": DINO_SIZE[1], "steps": DINO_STEPS,
                   "run_seconds": run_s, "ms_per_step_incl_warp_err": run_s * 1e3 / DINO_STEPS,
                   "warp_err_trajectory": curve, "warp_err_initial": err0,
                   "warp_err_final": err1, "identity_warp_err": identity,
                   "abs_err_fell": err1 < err0, "launches": dino_launches,
                   "warp_err_calls": evals}
    checks += [
        (all(np.isfinite([e for _, a, s in curve for e in (a, s)])) and np.isfinite(err1),
         f"examples: the turntable's warp_err is not finite: {curve}"),
        (err0 < identity,
         f"examples: the ground-truth warp at init ({err0}) does not beat the identity "
         f"warp ({identity})"),
        (dino_launches == expected,
         f"examples: turntable launches {dino_launches}, expected {expected}"),
    ]

    out["dino_missing_root"] = {"returned": skipped, "printed": printed.getvalue().strip()}
    checks.append((skipped is None
                   and printed.getvalue().startswith("dino dataset unavailable (needs "),
                   f"examples: the missing root's skip: {out['dino_missing_root']}"))
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)
    return {"toy": toy_launches, "dino": dino_launches}


@contextlib.contextmanager
def counted_collectives():
    """Within: every torch.distributed.all_reduce (the only collective of
    a step; its callers look it up at each call) counted, apart as made
    while the calling thread's stream captures a graph or not."""
    counts = {"captured": 0, "eager": 0}
    original = dist.all_reduce

    def counting(*args, **kwargs):
        counts["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return original(*args, **kwargs)

    dist.all_reduce = counting
    try:
        yield counts
    finally:
        dist.all_reduce = original


def _first_difference(got, want):
    """The first key of two dicts of tensors that differ (or whose keys
    do), with its max abs difference; None where they are equal bit for
    bit."""
    if sorted(got) != sorted(want):
        return f"keys {sorted(set(got) ^ set(want))}"
    for key in want:
        if not torch.equal(got[key], want[key]):
            diff = (float((got[key].double() - want[key].double()).abs().max())
                    if got[key].shape == want[key].shape else "shape")
            return f"{key}: max abs {diff}"
    return None


def mesh_graph_train(config, batches, device, mesh, counts):
    """The train step under `mesh`: a Trainer with graph=False, then one
    captured by default from the same seed (the eager one's metrics and
    state kept on the host and the trainer freed first), on `batches`.
    -> (record, checks)."""
    eager = Trainer(config, device=device, mesh=mesh, graph=False)
    want = []
    for batch in batches:
        metrics = eager.train_step(batch)
        want.append(({k: v.detach().cpu() for k, v in metrics.items()}, _graph_state(eager)))
    del eager, metrics
    release_memory()
    captured = Trainer(config, device=device, mesh=mesh)
    graphs = captured.train_step.graphs
    differ = []
    for i, batch in enumerate(batches):
        before = counts["captured"]
        got = captured.train_step(batch)
        if i == 1:
            collectives = counts["captured"] - before
        got = {k: v.detach().cpu() for k, v in got.items()}
        differ.append(_first_difference(got, want[i][0])
                      or _first_difference(_graph_state(captured), want[i][1]))
    record = {"steps": len(batches), "differ": differ, "graphs": len(graphs.graphs),
              "replays": graphs.replays,
              "launches_per_replay": [g.launches for g in graphs.graphs.values()],
              "capture_seconds": [g.seconds for g in graphs.graphs.values()],
              "pool_bytes": pool_bytes(graphs.pool),
              "collectives_captured_per_step": collectives}
    checks = [
        (all(d is None for d in differ),
         f"mesh_graph: captured train step differs from eager: {differ}"),
        (len(graphs.graphs) == 1 and graphs.replays == len(batches) - 1,
         f"mesh_graph: {len(graphs.graphs)} graphs, {graphs.replays} replays"),
        (record["launches_per_replay"] == [expected_launches(config.action.loss_mode)],
         f"mesh_graph: launches a replay {record['launches_per_replay']}"),
        (collectives > 0, "mesh_graph: no collective was captured"),
    ]
    return captured, record, checks


def mesh_graph_multi(config, batches, device, mesh, counts):
    """make_multi_step(MESH_MULTI) under `mesh`, graph=False and then
    captured, from the same seed, over the same 3 calls (the captured
    one's first eager, its second captures, its third replays); the state
    after each call. -> (record, checks)."""
    def stacked(chunk):
        return {k: np.stack([b[k] for b in chunk]) for k in chunk[0]}

    chunks = [batches[i * MESH_MULTI:(i + 1) * MESH_MULTI] for i in range(3)]
    runs = []
    for graph in (False, None):
        owner = Trainer(config, device=device, mesh=mesh, graph=False)
        multi = make_multi_step(owner.state, MESH_MULTI, mesh=mesh, device=device,
                                graph=graph,
                                **{k: getattr(owner.train_step, k) for k in STEP_ARGS})
        states, collectives = [], None
        for i, chunk in enumerate(chunks):
            before = counts["captured"]
            metrics = multi(stacked(chunk))
            if i == 1:
                collectives = counts["captured"] - before
            states.append(({k: v.detach().cpu() for k, v in metrics.items()},
                           _graph_state(owner)))
        graphs = multi.train_step.graphs
        runs.append((states, graphs and {
            "graphs": len(graphs.graphs), "replays": graphs.replays,
            "launches_per_replay": [g.launches for g in graphs.graphs.values()],
            "capture_seconds": [g.seconds for g in graphs.graphs.values()],
            "pool_bytes": pool_bytes(graphs.pool),
            "collectives_captured_per_step": collectives / MESH_MULTI}))
        del owner, multi, graphs
        release_memory()
    (want, _), (got, record) = runs
    differ = [_first_difference(g[0], w[0]) or _first_difference(g[1], w[1])
              for g, w in zip(got, want)]
    record.update({"num_steps": MESH_MULTI, "calls": len(chunks), "differ": differ})
    per_replay = {k: MESH_MULTI * v for k, v in expected_launches(config.action.loss_mode).items()}
    checks = [
        (all(d is None for d in differ), f"mesh_graph: captured multi-step differs: {differ}"),
        (record["graphs"] == 1 and record["replays"] == 2,
         f"mesh_graph: multi-step {record['graphs']} graphs, {record['replays']} replays"),
        (record["launches_per_replay"] == [per_replay],
         f"mesh_graph: multi-step launches a replay {record['launches_per_replay']}"),
    ]
    return record, checks


def mesh_graph_eval(trainer, batches, device, mesh, counts):
    """The eval step under `mesh` (Eigen protocol, pose metrics) captured
    against graph=False on the same modules, over `batches`."""
    act = trainer.config.action
    kwargs = dict(loss_mode=act.loss_mode, depth_norm=act.depth_norm,
                  precision=act.precision, eval_protocol="eigen", pose_metrics=True,
                  mesh=mesh, device=device)
    state = trainer.state
    captured = make_eval_step(state.depth_model, state.pose_model, **kwargs)
    eager = make_eval_step(state.depth_model, state.pose_model, graph=False, **kwargs)
    differ = []
    for i, batch in enumerate(batches):
        before = counts["captured"]
        (got, got_depth), (want, want_depth) = captured(batch), eager(batch)
        if i == 1:
            collectives = counts["captured"] - before
        differ.append(_first_difference({**got, "depth_pred": got_depth},
                                        {**want, "depth_pred": want_depth}))
    graphs = captured.graphs
    record = {"batches": len(batches), "differ": differ, "replays": graphs.replays,
              "launches_per_replay": [g.launches for g in graphs.graphs.values()],
              "capture_seconds": [g.seconds for g in graphs.graphs.values()],
              "pool_bytes": pool_bytes(graphs.pool),
              "collectives_captured_per_call": collectives}
    checks = [(all(d is None for d in differ),
               f"mesh_graph: captured eval step differs: {differ}"),
              (graphs.replays == len(batches) - 1,
               f"mesh_graph: eval replays {graphs.replays}")]
    del captured, eager
    return record, checks


def mesh_graph_phase(device):
    """The step captured under an NCCL mesh (see the module docstring's
    `mesh_graph`). Prints the phase's record, then checks it; returns the
    train step's launches a replay."""
    t_phase = time.perf_counter()
    out, checks = {"phase": "mesh_graph", "card": card()}, []
    config = load_config(BASIC_CONFIG)
    batch_size, (height, width) = config.action.batch_size, config.image_shape
    batches = list(SyntheticTripletDataset(3 * MESH_MULTI, batch_size, height, width,
                                           seed=SEED + 61, uint8_images=True).batches())
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device=device)
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh(1, device=device)
        out.update({"backend": dist.get_backend(), "world": mesh.size,
                    "capturable": mesh.capturable, "batch": batch_size, "height": height,
                    "width": width, "loss_mode": config.action.loss_mode,
                    "precision": config.action.precision})
        checks.append((mesh.capturable, "mesh_graph: the NCCL mesh is not capturable"))
        with counted_collectives() as counts:
            trainer, out["train"], more = mesh_graph_train(config, batches[:MESH_STEPS],
                                                           device, mesh, counts)
            checks += more
            trainer.train_step.graphs.reset()
            release_memory()
            out["eval"], more = mesh_graph_eval(trainer, batches[:MESH_EVAL], device, mesh,
                                                counts)
            checks += more
            del trainer
            release_memory()
            out["multi_step"], more = mesh_graph_multi(config, batches, device, mesh, counts)
            checks += more
        out["collectives_eager_total"] = counts["eager"]
        torch.backends.cudnn.deterministic = False
        batch = {k: torch.as_tensor(v).to(device) for k, v in batches[0].items()}
        for label, graph in (("captured", None), ("eager", False)):
            out[label] = graph_timing(config, device, batch, graph, mesh)
        out["host_ms_ratio_captured_to_eager"] = (out["captured"]["ms_per_step_host"]
                                                  / out["eager"]["ms_per_step_host"])
        checks.append((out["captured"]["graph_launches_per_step"] == 1.0,
                       f"mesh_graph: graph launches a step "
                       f"{out['captured']['graph_launches_per_step']}"))
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)
    return out["train"]["launches_per_replay"][0]


def _named(trainer, what):
    """{net.key: tensor on the CPU} of a Trainer's parameter gradients
    ("grads"; a parameter without one is left out), parameters ("params")
    or BatchNorm running statistics ("stats")."""
    out = {}
    for net, model in (("depth", trainer.state.depth_model), ("pose", trainer.state.pose_model)):
        if what == "stats":
            out.update({f"{net}.{k}": v.detach().cpu().clone()
                        for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))})
            continue
        for k, p in model.named_parameters():
            t = p.grad if what == "grads" else p
            if t is not None:
                out[f"{net}.{k}"] = t.detach().cpu().clone()
    return out


def _grad_compare(got, ref):
    """(rel L2 of every gradient concatenated, (worst key's rel L2, key))."""
    check(sorted(got) == sorted(ref), "the gradients are of other parameters")
    flat_rel = rel_l2(torch.cat([got[k].reshape(-1) for k in sorted(ref)]),
                      torch.cat([ref[k].reshape(-1) for k in sorted(ref)]))
    worst = max((rel_l2(got[k], ref[k]), k) for k in ref if float(ref[k].abs().max()) > 0)
    return flat_rel, worst


def parallel_cases(basic_config, mean_config):
    """(name, config, batches) of the 2-rank checks: basic_config ('min',
    1280x384, batch 4) for TRAIN_STEPS steps, configs/synthetic.yaml's
    'mean' (640x192, batch 12) and its 'ssim' for one step each (the
    configs' paths given: a spawned rank reads no patched global)."""
    cases = []
    for name, path, mode, steps in (("basic_config", basic_config, None, TRAIN_STEPS),
                                    ("mean", mean_config, "mean", 1),
                                    ("ssim", mean_config, "ssim", 1)):
        config = load_config(path)
        if mode is not None:
            config.action.loss_mode = mode
        batches = list(SyntheticTripletDataset(steps, config.action.batch_size,
                                               *config.image_shape, seed=SEED + 31,
                                               uint8_images=True).batches())
        cases.append((name, config, batches))
    return cases


def parallel_trainer(config, device, mesh=None, graph=False):
    """A Trainer (under `mesh`) from the seed, eager by default (graph=False:
    the one-process steps the meshed ones are held to; `graph` None lets
    the mesh decide: captured under NCCL, eager under gloo), PoseFc's head
    given a seeded translation bias: its zero-initialized last layer makes the warp the
    identity, which puts every warp sample ON a pixel, where the bilinear
    gradient jumps, so that a 1-ulp difference of the depth flips it (the
    reason tests/test_torch_train.py gives its pose head a bias)."""
    trainer = Trainer(config, device=device, mesh=mesh, graph=graph)
    pose = trainer.state.pose_model
    if type(pose).__name__ == "PoseFc":
        bias = torch.randn(pose.fc_loc[-1].bias.shape,
                           generator=torch.Generator().manual_seed(SEED)) * 0.03
        with torch.no_grad():
            pose.fc_loc[-1].bias.copy_(bias)
    return trainer


def parallel_steps(config, batches, device, mesh=None, graph=False):
    """parallel_trainer's train step on each of `batches` -> the first
    step's metrics, gradients and BatchNorm statistics, the parameters
    after the last, each step's launches and its ms by CUDA events (None
    off the card: a CPU rehearsal), and whether the step had graphs."""
    trainer = parallel_trainer(config, device, mesh, graph)
    on_card = device.type == "cuda"
    out = {"launches": [], "ms_per_step": [],
           "captured": trainer.train_step.graphs is not None}
    for i, batch in enumerate(batches):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        kernels.reset_launch_counts()
        metrics = trainer.train_step(batch)
        if on_card:
            end.record()
            torch.cuda.synchronize()
        out["launches"].append(dict(kernels.launch_counts))
        out["ms_per_step"].append(start.elapsed_time(end) if on_card else None)
        if i == 0:
            out["metrics"] = {k: float(v) for k, v in metrics.items()}
            out["grads"] = _named(trainer, "grads")
            out["stats"] = _named(trainer, "stats")
    out["params"] = _named(trainer, "params")
    return out


def copy_trainer_state(dst, src):
    """src's parameters, buffers, optimizer slots and learning rates
    copied into dst's tensors in place (the optimizer's slots where both
    have them)."""
    for name in ("depth_model", "pose_model"):
        getattr(dst.state, name).load_state_dict(getattr(src.state, name).state_dict())
    dst_opt, src_opt = dst.state.optimizer, src.state.optimizer
    with torch.no_grad():
        for dst_group, src_group in zip(dst_opt.param_groups, src_opt.param_groups):
            dst_group["lr"] = src_group["lr"]
            for p, q in zip(dst_group["params"], src_group["params"]):
                for key, value in src_opt.state.get(q, {}).items():
                    dst_opt.state[p][key].copy_(value)


def parallel_rank(rank, world, port, out_path, device, configs):
    """One of `world` gloo ranks on `device`, cuda:0 for all (spawned by
    parallel_phase): parallel_steps of every parallel_cases(*configs)
    case under the mesh, saved to out_path (or the rank's traceback)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda":
        build.load_libraries()
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device=device, backend="gloo")
    try:
        mesh = make_mesh(world, device=device)
        # graph=None: a gloo mesh runs eagerly
        result = {"ok": {name: parallel_steps(config, batches, device, mesh, graph=None)
                         for name, config, batches in parallel_cases(*configs)}}
    except BaseException:  # reported by the parent with its traceback
        result = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(result, out_path)


def parallel_phase(device):
    """Data parallelism on the card (see the module docstring). Prints the
    phase's record, then checks it; returns each rank's launches over
    basic_config's steps."""
    t_phase = time.perf_counter()
    out, checks = {"phase": "parallel", "card": card()}, []

    # world size 1 under NCCL, in this process
    config = load_config(BASIC_CONFIG)
    mode = config.action.loss_mode
    batches = list(SyntheticTripletDataset(TRAIN_STEPS, config.action.batch_size,
                                           *config.image_shape, seed=SEED + 37,
                                           uint8_images=True).batches())
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device=device)
    try:
        mesh = make_mesh(1, device=device)
        plain = parallel_trainer(config, device)
        # captured, as an NCCL mesh's step is by default: the first step
        # eager, the second captures, the third replays
        meshed = parallel_trainer(config, device, mesh, graph=None)
        record = {"backend": dist.get_backend(), "steps": [],
                  "captured": meshed.train_step.graphs is not None}
        launches = dict.fromkeys(kernels.KERNELS, 0)
        for batch in batches:
            # each step from the plain trainer's state: Adam's first update
            # is ±lr wherever a gradient is not 0, so a 1e-7 difference of a
            # gradient near 0 would move a parameter by 2·lr and the next
            # steps would compare other points. Copied in place: the
            # captured step reads the tensors where they lie
            copy_trainer_state(meshed, plain)
            plain_metrics = plain.train_step(batch)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            mesh_metrics = meshed.train_step(batch)
            torch.cuda.synchronize()
            launches = {k: launches[k] + kernels.launch_counts[k] for k in launches}
            rel, worst = _grad_compare(_named(meshed, "grads"), _named(plain, "grads"))
            record["steps"].append({"grad_rel_l2": rel, "worst_key": worst[1],
                                    "worst_key_rel_l2": worst[0],
                                    "loss": float(mesh_metrics["loss"]),
                                    "loss_plain": float(plain_metrics["loss"])})
        record["launches"] = launches
        record["replays"] = meshed.train_step.graphs.replays
        checks.append((record["captured"] and record["replays"] == TRAIN_STEPS - 1,
                       f"world 1: captured {record['captured']}, {record['replays']} replays"))
        expected = {k: TRAIN_STEPS * v for k, v in expected_launches(mode).items()}
        checks += [(launches == expected, f"world 1: launches {launches}, expected {expected}"),
                   (max(s["grad_rel_l2"] for s in record["steps"]) <= GRAD_REL_L2,
                    f"world 1 vs plain: gradient rel L2 {record['steps']} > {GRAD_REL_L2}")]
        out["world1_nccl"] = record
        del plain, meshed
    finally:
        dist.destroy_process_group()
    release_memory()

    # PARALLEL_RANKS gloo ranks spawned on this card, against the
    # one-process steps on the whole batches (taken while they run)
    t0 = time.perf_counter()
    port = distributed.free_port()
    configs = (BASIC_CONFIG, MEAN_CONFIG)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(PARALLEL_RANKS)]
        procs = [ctx.Process(target=parallel_rank,
                             args=(r, PARALLEL_RANKS, port, paths[r], str(device), configs))
                 for r in range(PARALLEL_RANKS)]
        for proc in procs:
            proc.start()
        try:
            refs = {name: parallel_steps(config, batches, device)
                    for name, config, batches in parallel_cases(*configs)}
            for proc in procs:
                proc.join(PARALLEL_TIMEOUT_S)
            check(not any(p.is_alive() for p in procs),
                  f"the gloo ranks still ran after {PARALLEL_TIMEOUT_S} s")
            results = []
            for rank, (proc, path) in enumerate(zip(procs, paths)):
                check(os.path.exists(path), f"rank {rank} exited with {proc.exitcode}")
                result = torch.load(path, weights_only=False)
                check("error" not in result, f"rank {rank}: {result.get('error')}")
                results.append(result["ok"])
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
    out["gloo_ranks_seconds"] = time.perf_counter() - t0
    cases = {}
    for name, config, batches in parallel_cases(*configs):
        ref, ranks = refs[name], [r[name] for r in results]
        rel, worst = _grad_compare(ranks[0]["grads"], ref["grads"])
        stats_rel, stats_key = max((float(((ranks[0]["stats"][k] - v).abs()
                                            / (v.abs() + 1.0)).max()), k)
                                   for k, v in ref["stats"].items())
        params_ok = all(torch.allclose(ranks[0]["params"][k], v, rtol=PARALLEL_PARAMS_RTOL,
                                       atol=PARALLEL_PARAMS_ATOL)
                        for k, v in ref["params"].items())
        loss_rel = _rel(ranks[0]["metrics"]["loss"], ref["metrics"]["loss"])
        per_step = expected_launches(config.action.loss_mode)
        cases[name] = {
            "batch": config.action.batch_size, "rows_per_rank":
                config.action.batch_size // PARALLEL_RANKS,
            "height": config.image_shape[0], "width": config.image_shape[1],
            "loss_mode": config.action.loss_mode, "steps": len(batches),
            "loss": ranks[0]["metrics"]["loss"], "loss_one_process": ref["metrics"]["loss"],
            "loss_rel": loss_rel, "grad_rel_l2": rel, "worst_key": worst[1],
            "worst_key_rel_l2": worst[0], "bn_stats_max_rel": stats_rel,
            "bn_stats_worst_key": stats_key,
            "params_after_last_step_close": params_ok,
            "launches_per_rank": [r["launches"] for r in ranks],
            "ms_per_step_per_rank_two_ranks_on_one_card": [r["ms_per_step"] for r in ranks],
            "ms_per_step_one_process": ref["ms_per_step"],
        }
        checks += [
            (not any(r["captured"] for r in ranks), f"{name}: a gloo rank captured its step"),
            (all(r["metrics"] == ranks[0]["metrics"] for r in ranks),
             f"{name}: the ranks' metrics differ"),
            (all(torch.equal(r["grads"][k], ranks[0]["grads"][k])
                 for r in ranks for k in ranks[0]["grads"]),
             f"{name}: the ranks' gradients differ"),
            (loss_rel <= PARALLEL_LOSS_RTOL, f"{name}: loss rel {loss_rel}"),
            (rel <= GRAD_REL_L2, f"{name}: gradient rel L2 {rel} (worst {worst})"),
            (stats_rel <= PARALLEL_STATS_RTOL, f"{name}: BatchNorm statistics rel {stats_rel}"),
            (params_ok, f"{name}: parameters after {len(batches)} steps differ"),
            (all(launches == per_step for r in ranks for launches in r["launches"]),
             f"{name}: launches a step {[r['launches'] for r in ranks]}, expected {per_step}"),
        ]
    out["gloo_ranks_on_one_card"] = cases

    # the CLI: --mesh 1 trains in this process; --mesh 2 needs 2 cards
    with tempfile.TemporaryDirectory() as tmp:
        with open(MEAN_CONFIG) as f:
            raw = yaml.safe_load(f)
        raw["action"]["checkpoint_dir"] = tmp
        path = _write_yaml(os.path.join(tmp, "synthetic.yaml"), raw)
        argv = ["--config", path, "--synthetic", "--epochs", "1", "--synthetic-batches", "1"]
        trainer, _ = _quiet(train_cli.main, [*argv, "--mesh", "1"])
        cli = {"mesh_1_steps": trainer.state.step, "devices": torch.cuda.device_count()}
        checks.append((trainer.mesh is None and trainer.state.step == 1,
                       f"cli.train --mesh 1: {cli}"))
        del trainer
        if torch.cuda.device_count() == 1:
            try:
                _quiet(train_cli.main, [*argv, "--mesh", "2"])
                cli["mesh_2_error"] = None
            except ValueError as e:
                cli["mesh_2_error"] = str(e)
            checks.append(("found 1" in (cli["mesh_2_error"] or ""),
                           f"cli.train --mesh 2 on one card: {cli['mesh_2_error']}"))
    out["cli"] = cli
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)
    return [{k: sum(step[k] for step in r["basic_config"]["launches"]) for k in kernels.KERNELS}
            for r in results]


def spatial_groups():
    """The spatial phase's groups of gloo ranks: (ranks, spatial size,
    cases, the config Trainer.fit runs with a wandb stub or None). A case
    is (name, config path, overrides, steps): overrides set the config's
    action keys, and "all_scales" DispResNet's (the configs' paths given:
    a spawned rank reads no patched global); "depth" and "pose" replace a
    net by (name, kwargs), "image_shape" the image's (height, width)."""
    return ((2, 2, (("basic_config", BASIC_CONFIG, {}, 2),
                    ("basic_config_remat", BASIC_CONFIG, {"remat": True}, 2),
                    ("all_scales_2", BASIC_CONFIG, {"all_scales": True}, 2),
                    ("dispnets_2", BASIC_CONFIG, {"depth": ("DispNetS", {})}, 2),
                    ("stn_2", BASIC_CONFIG, {"depth": ("StnDispNet", {"use_stn": True})}, 2)),
             BASIC_CONFIG),
            (2, 2, (("bts_1x2", BASIC_CONFIG, {**BTS_CASE, "batch_size": 4}, 2),
                    # the non-integer resamples of a band
                    ("all_scales_h188", BASIC_CONFIG,
                     {"all_scales": True, "image_shape": (188, 640)}, 2),
                    ("dispnets_h188", BASIC_CONFIG,
                     {"depth": ("DispNetS", {}), "image_shape": (188, 640)}, 2),
                    ("stn_h184", BASIC_CONFIG,
                     {"depth": ("StnDispNet", {"use_stn": True}), "image_shape": (184, 640)},
                     2)), None),
            (4, 2, (("ssim_2x2", MEAN_CONFIG, {"loss_mode": "ssim"}, 2),), None),
            # the precision override: fp32 (TF32 off) for the checks, then
            # one step at the config's own bf16
            (4, 4, (("tpu_v5e_4", CONFIG, {"precision": "fp32"}, 2),
                    ("tpu_v5e_4_bf16", CONFIG, {}, 1),
                    # batch 2: a rank holds 1/4 of 4 images' rows
                    ("bts_1x4", BASIC_CONFIG, {**BTS_CASE, "batch_size": 2}, 2)), None),
            # JAX's equal bands of 24 rows (ceil(192 / 32) = 6 < 8): layer3,
            # layer4 and the decoder's 32x and 16x stages run gathered
            (8, 8, (("tpu_v5e_8", CONFIG, {"precision": "fp32"}, 2),), None))


def spatial_setup(path, overrides, steps):
    """(config, the case's global batches) of a spatial case."""
    config = load_config(path)
    for key, value in overrides.items():
        if key == "all_scales":
            config.model.depth.kwargs = {**config.model.depth.kwargs, "all_scales": value}
        elif key in ("depth", "pose"):
            net = getattr(config.model, key)
            net.name, net.kwargs = value[0], dict(value[1])
        elif key == "image_shape":
            aug = config.datasets.augmentation
            aug.image_height, aug.image_width = value
        else:
            setattr(config.action, key, value)
    batches = list(SyntheticTripletDataset(steps, config.action.batch_size,
                                           *config.image_shape, seed=SEED + 41,
                                           uint8_images=True).batches())
    return config, batches


def spatial_steps(trainer, batches, device, starts=None):
    """trainer's train step on each of `batches` -> per step the metrics,
    gradients, BatchNorm statistics, launches, ms by CUDA events, peak
    memory allocated and reserved, the card's free memory after the step
    (every process's use), and the memory the autograd graph holds when the
    loss is computed — allocated then, less allocated before the step:
    the saved activations, without cuDNN's transient workspaces (None off
    the card: a CPU rehearsal; with remat the loss's forward keeps only
    its inputs). Each step starts from the state in `starts`; without
    them the steps follow each other, and each step's record holds the
    state it started from ("start", on the CPU)."""
    on_card = device.type == "cuda"
    out = []
    held = []
    loss_fn = trainer.train_step.loss_fn

    def loss_fn_held(batch):
        result = loss_fn(batch)
        if on_card:
            held.append(torch.cuda.memory_allocated(device))
        return result

    trainer.train_step.loss_fn = loss_fn_held
    for i, batch in enumerate(batches):
        parts = ("depth_model", "pose_model", "optimizer")
        if starts is not None:
            for name in parts:
                getattr(trainer.state, name).load_state_dict(starts[i][name])
        else:
            start = {name: _to_cpu(getattr(trainer.state, name).state_dict())
                     for name in parts}
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            before = torch.cuda.memory_allocated(device)
            held.clear()
        kernels.reset_launch_counts()
        metrics = trainer.train_step(batch)
        if on_card:
            events[1].record()
            torch.cuda.synchronize()
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": _named(trainer, "grads"), "stats": _named(trainer, "stats"),
                    "launches": dict(kernels.launch_counts),
                    "ms": events[0].elapsed_time(events[1]) if on_card else None,
                    "peak_bytes": torch.cuda.max_memory_allocated(device) if on_card
                    else None,
                    "reserved_bytes": torch.cuda.max_memory_reserved(device) if on_card
                    else None,
                    "card_free_bytes": torch.cuda.mem_get_info(device)[0] if on_card
                    else None,
                    "graph_bytes": held[0] - before if on_card else None,
                    "scales": len(depth_scales(trainer.state.depth_model))})
        if starts is None:
            out[-1]["start"] = start
    del trainer.train_step.loss_fn  # the wrapper and the step made a cycle
    return out


class _StubWandb(types.ModuleType):
    """The wandb calls utils/logging.MetricLogger makes, recorded (no
    wandb on the card's machine, and no network)."""

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


def spatial_fit(mesh, device, directory, path):
    """Trainer.fit of the config at `path` under the mesh for one epoch of 2
    synthetic batches, rank 0 logging to a wandb stub (log_warps under the
    mesh: every rank of the data row runs the banded forward, rank 0
    renders) -> the step, the pictures this rank handed to the PNG writer
    (target, ref0 warped, depth), the image names the stub received, the
    seconds; on rank 0 also the pictures a Trainer without the mesh
    renders from rank 0's state and last batch."""
    from unsupervised_pseuso_lidar_tpu_torch.utils import visualization
    from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger

    stub = _StubWandb()
    sys.modules["wandb"] = stub
    config = load_config(path)
    config.action.mlops = True
    config.action.num_epochs = 1
    config.action.log_freq = 100
    config.action.checkpoint_dir = os.path.join(directory, "checkpoints")
    pictures_dir = os.path.join(directory, f"rank{mesh.rank}")
    os.makedirs(pictures_dir, exist_ok=True)
    os.chdir(pictures_dir)  # log_warps writes ./images
    rendered = []
    save = visualization.save_warp_visualization

    def record(out_dir, step, tgt, warped, depth, *args, **kwargs):
        rendered.append((tgt, warped, depth))
        return save(out_dir, step, tgt, warped, depth, *args, **kwargs)

    visualization.save_warp_visualization = record
    data = SyntheticTripletDataset(2, config.action.batch_size, *config.image_shape,
                                   seed=SEED + 43, uint8_images=True)
    trainer = Trainer(config, data, log_fn=MetricLogger(config) if mesh.rank == 0 else None,
                      device=device, mesh=mesh)
    t0 = time.perf_counter()
    trainer.fit(lambda epoch: data.batches(epoch))
    seconds = time.perf_counter() - t0
    one_process = None
    if mesh.rank == 0:
        plain = Trainer(config, device=device)
        for part in ("depth_model", "pose_model"):
            getattr(plain.state, part).load_state_dict(getattr(trainer.state, part).state_dict())
        one_process = plain.warp_pictures(trainer._last_batch)
    images = [sorted(p) for p, _ in stub.logged if any(k.endswith(".png") for k in p)]
    return {"step": trainer.state.step, "pictures": rendered, "one_process": one_process,
            "logged_images": images, "seconds": seconds}


def spatial_rank(rank, world, spatial, port, out_path, device, cases, starts_path,
                 fit_dir, fit_config, memory_fraction=None):
    """One of `world` gloo ranks on `device` (cuda:0 for all) under
    make_mesh(world, spatial): spatial_steps of each case from the states
    in starts_path, then with fit_config spatial_fit under fit_dir, saved
    to out_path (or the rank's traceback). On the card its caching
    allocator is capped at `memory_fraction` of the card: ranks that
    share a card cannot free each other's cached blocks, so without a cap
    one rank's cache can starve another's allocation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as in the parent (spatial_phase)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_per_process_memory_fraction(memory_fraction, device)
        build.load_libraries()
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device=device, backend="gloo")
    try:
        mesh = make_mesh(world, spatial=spatial, device=device)
        starts = torch.load(starts_path, weights_only=False)
        out = {}
        for name, path, overrides, steps in cases:
            config, batches = spatial_setup(path, overrides, steps)
            trainer = parallel_trainer(config, device, mesh, graph=None)
            check(trainer.train_step.graphs is None, f"{name}: a gloo rank captured its step")
            out[name] = spatial_steps(trainer, batches, device, starts[name])
            del trainer
            gc.collect()
            if device.type == "cuda":
                release_memory()
        if fit_config is not None:
            out["fit"] = spatial_fit(mesh, device, fit_dir, fit_config)
        out["memory_cap_bytes"] = (memory_fraction * torch.cuda.mem_get_info(device)[1]
                                   if device.type == "cuda" else None)
        result = {"ok": out}
    except BaseException:  # reported by the parent with its traceback and time
        result = {"error": traceback.format_exc(), "at": time.time()}
    finally:
        dist.destroy_process_group()
    torch.save(result, out_path)


def _spawn_spatial_group(world, spatial, cases, starts, fit_config, device):
    """Run spatial_rank on `world` spawned gloo ranks, all on `device` (the
    one card), each with an equal share of the card's free memory (less
    RANK_OVERHEAD_BYTES) -> their results, rank order (a rank's failure or
    a hang raises, naming every rank's error, earliest first, and exit
    code)."""
    ctx = mp.get_context("spawn")
    port = distributed.free_port()
    fraction = None
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        fraction = (free / world - RANK_OVERHEAD_BYTES) / total
        check(fraction > 0, f"spatial {world}x{spatial}: {_mib(free)} MiB free on the card")
    with tempfile.TemporaryDirectory() as tmp:
        starts_path = os.path.join(tmp, "starts.pt")
        torch.save(starts, starts_path)
        paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        fit_dir = os.path.join(tmp, "fit")
        procs = [ctx.Process(target=spatial_rank,
                             args=(r, world, spatial, port, paths[r], str(device), cases,
                                   starts_path, fit_dir, fit_config, fraction))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        try:
            for proc in procs:
                proc.join(PARALLEL_TIMEOUT_S)
            check(not any(p.is_alive() for p in procs),
                  f"spatial {world}x{spatial}: the gloo ranks still ran after "
                  f"{PARALLEL_TIMEOUT_S} s")
            # every rank's outcome first: a rank that fails closes its
            # peers' connections, so the first error is rarely the cause
            ranks, errors = [], []
            for rank, (proc, rank_path) in enumerate(zip(procs, paths)):
                if not os.path.exists(rank_path):
                    errors.append((0.0, f"rank {rank} exited with {proc.exitcode} and no "
                                        "result"))
                    continue
                result = torch.load(rank_path, weights_only=False)
                if "error" in result:
                    errors.append((result["at"], f"rank {rank} (exit code {proc.exitcode}, "
                                                 f"at {result['at']:.3f}): {result['error']}"))
                else:
                    ranks.append(result["ok"])
            check(not errors, f"spatial {world}x{spatial}: " + "\n".join(
                e for _, e in sorted(errors)))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
    return ranks


def spatial_phase(device, groups=None):
    """The "spatial" mesh axis on the card (see the module docstring), over
    `groups` (spatial_groups' by default). Prints the phase's record, then
    checks it; returns each rank's launches over basic_config's steps.
    Every step of the phase, here and on the ranks (spatial_rank), runs
    with cuDNN deterministic: a step then repeats bit for bit, so the
    comparison of a steep gradient (StnDispNet's STN at step 2 of `stn_2`)
    reads the same in every run instead of moving with the order of
    cuDNN's atomic adds."""
    torch.backends.cudnn.deterministic = True
    try:
        return _spatial_phase(device, groups)
    finally:
        torch.backends.cudnn.deterministic = False


def _spatial_phase(device, groups):
    t_phase = time.perf_counter()
    out, checks = {"phase": "spatial", "card": card()}, []
    rank_launches = None
    one_process = {}
    for world, spatial, cases, fit_config in groups or spatial_groups():
        # the one-process steps on the whole batches, alone on the card (with
        # remat off: the reference of a remat case too); the state before
        # each is the ranks' start
        refs, starts = {}, {}
        for name, path, overrides, steps in cases:
            plain = {k: v for k, v in overrides.items() if k != "remat"}
            key = (path, json.dumps(plain, sort_keys=True), steps)
            if key not in one_process:
                config, batches = spatial_setup(path, plain, steps)
                trainer = parallel_trainer(config, device)
                one_process[key] = spatial_steps(trainer, batches, device)
                del trainer
                release_memory()
            refs[name] = one_process[key]
            starts[name] = [ref["start"] for ref in refs[name]]
        t0 = time.perf_counter()
        ranks = _spawn_spatial_group(world, spatial, cases, starts, fit_config, device)
        ranks_seconds = time.perf_counter() - t0
        # beside the plain step: the same steps under a one-rank data mesh
        # (the bands' BatchNorm on the whole batch)
        beside = tuple(case for case in cases if case[0] in ONE_RANK_BESIDE)
        one_rank = (_spawn_spatial_group(1, 1, beside, starts, None, device)[0]
                    if beside else {})
        for name, path, overrides, steps in cases:
            config = spatial_setup(path, overrides, 1)[0]
            bf16 = config.action.precision == "bf16"
            scales = refs[name][0]["scales"]
            per_step = expected_launches(config.action.loss_mode, scales, config.action.remat)
            height = config.image_shape[0]
            record = {"ranks": world, "mesh": {"data": world // spatial, "spatial": spatial},
                      "overrides": overrides, "batch": config.action.batch_size,
                      "height": height, "width": config.image_shape[1],
                      "rows_per_rank": [b - a for a, b in row_bands(height, spatial)],
                      "images_per_rank": config.action.batch_size * spatial // world,
                      "loss_mode": config.action.loss_mode, "pose": config.model.pose.name,
                      "depth": config.model.depth.name, "scales": scales,
                      "precision": config.action.precision, "remat": config.action.remat,
                      "depth_norm": config.action.depth_norm, "steps": [],
                      "group_ranks_seconds": ranks_seconds,
                      "memory_cap_mib_per_rank": [_mib(r["memory_cap_bytes"]) for r in ranks]}
            for i, ref in enumerate(refs[name]):
                got = ranks[0][name][i]
                rel, worst = _grad_compare(got["grads"], ref["grads"])
                stats_rel = max((float(((got["stats"][k] - v).abs() / (v.abs() + 1.0)).max())
                                 for k, v in ref["stats"].items()), default=0.0)
                loss_rel = _rel(got["metrics"]["loss"], ref["metrics"]["loss"])
                step = {
                    "loss": got["metrics"]["loss"], "loss_one_process": ref["metrics"]["loss"],
                    "loss_rel": loss_rel, "grad_rel_l2": rel, "worst_key": worst[1],
                    "worst_key_rel_l2": worst[0], "bn_stats_max_rel": stats_rel,
                    "launches_per_rank": [r[name][i]["launches"] for r in ranks],
                    "ms_per_rank_ranks_on_one_card": [r[name][i]["ms"] for r in ranks],
                    "ms_one_process": ref["ms"],
                    "peak_mib_per_rank": [_mib(r[name][i]["peak_bytes"]) for r in ranks],
                    "peak_mib_one_process": _mib(ref["peak_bytes"]),
                    "reserved_mib_per_rank": [_mib(r[name][i]["reserved_bytes"]) for r in ranks],
                    "card_free_mib_per_rank": [_mib(r[name][i]["card_free_bytes"])
                                               for r in ranks],
                    "graph_mib_per_rank": [_mib(r[name][i]["graph_bytes"]) for r in ranks],
                    "graph_mib_one_process": _mib(ref["graph_bytes"])}
                # the banded step's gradient reference: the one-rank mesh
                # where there is one (then itself held to the plain step)
                grad_ref, grad_rel = "one process", rel
                if name in one_rank:
                    mesh_step = one_rank[name][i]
                    mesh_rel = _grad_compare(got["grads"], mesh_step["grads"])[0]
                    mesh_loss_rel = _rel(got["metrics"]["loss"], mesh_step["metrics"]["loss"])
                    drift = _grad_compare(mesh_step["grads"], ref["grads"])[0]
                    step.update(grad_rel_l2_one_rank_mesh=mesh_rel,
                                loss_rel_one_rank_mesh=mesh_loss_rel,
                                one_rank_mesh_grad_rel_l2_to_one_process=drift)
                    grad_ref, grad_rel = "the one-rank mesh", mesh_rel
                    checks += [(mesh_loss_rel <= SPATIAL_LOSS_RTOL,
                                f"{name} step {i}: loss rel {mesh_loss_rel} to the one-rank "
                                "mesh"),
                               (drift <= BN_SUM_GRAD_REL_L2,
                                f"{name} step {i}: the one-rank mesh's gradient rel L2 {drift} "
                                "to the one-process step")]
                checks += [
                    (all(r[name][i]["metrics"] == got["metrics"] for r in ranks),
                     f"{name} step {i}: the ranks' metrics differ"),
                    (all(torch.equal(r[name][i]["grads"][k], got["grads"][k])
                         for r in ranks for k in got["grads"]),
                     f"{name} step {i}: the ranks' gradients differ"),
                    (all(r[name][i]["launches"] == per_step for r in ranks),
                     f"{name} step {i}: launches {step['launches_per_rank']}, "
                     f"expected {per_step}"),
                ]
                if bf16:
                    # bf16 convolutions: the loss is reported beside the
                    # one-process bf16 step's, within SPATIAL_BF16_LOSS_RTOL
                    checks.append((loss_rel <= SPATIAL_BF16_LOSS_RTOL,
                                   f"{name} step {i}: bf16 loss rel {loss_rel}"))
                else:
                    checks += [
                        (loss_rel <= SPATIAL_LOSS_RTOL, f"{name} step {i}: loss rel {loss_rel}"),
                        (grad_rel <= GRAD_REL_L2,
                         f"{name} step {i}: gradient rel L2 {grad_rel} to {grad_ref} (to the "
                         f"one-process step {rel}, worst leaf {worst})"),
                        (stats_rel <= PARALLEL_STATS_RTOL,
                         f"{name} step {i}: BatchNorm statistics rel {stats_rel}"),
                    ]
                if config.action.remat:
                    # against the ranks' own remat-off steps from the same
                    # states: only memory and time may change
                    off = ranks[0][name.removesuffix("_remat")][i]
                    off_rel = _grad_compare(got["grads"], off["grads"])[0]
                    off_loss = _rel(got["metrics"]["loss"], off["metrics"]["loss"])
                    step.update(loss_rel_remat_off=off_loss, grad_rel_l2_remat_off=off_rel,
                                peak_mib_per_rank_remat_off=[
                                    _mib(r[name.removesuffix("_remat")][i]["peak_bytes"])
                                    for r in ranks])
                    checks += [(off_loss <= SPATIAL_LOSS_RTOL,
                                f"{name} step {i}: loss rel {off_loss} to remat off"),
                               (off_rel <= GRAD_REL_L2,
                                f"{name} step {i}: gradient rel L2 {off_rel} to remat off")]
                record["steps"].append(step)
            out[name] = record
            if name == "basic_config":
                rank_launches = [{k: sum(step["launches"][k] for step in r[name])
                                  for k in kernels.KERNELS} for r in ranks]
        if fit_config is not None:
            out["fit"], fit_checks = spatial_fit_record(ranks)
            checks += fit_checks
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for ok, what in checks:
        check(ok, what)
    return rank_launches


def spatial_repeat(world, runs, device="cuda:0"):
    """The spatial phase's groups of `world` ranks, `runs` times over on
    one card (python3 chip_smoke.py --spatial-repeat WORLD RUNS): each
    run's record, or its failure with every rank's error, earliest first,
    and exit code. Returns the number of runs that failed."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    build.load_libraries()
    groups = tuple(g for g in spatial_groups() if g[0] == world)
    check(bool(groups), f"no spatial group of {world} ranks")
    failed = 0
    for run in range(runs):
        try:
            spatial_phase(device, groups)
            emit({"phase": "spatial_repeat", "ranks": world, "run": run, "ok": True})
        except AssertionError as e:
            failed += 1
            emit({"phase": "spatial_repeat", "ranks": world, "run": run, "ok": False,
                  "error": str(e)})
    emit({"phase": "spatial_repeat", "ranks": world, "runs": runs, "failed": failed,
          "card": card()})
    return failed


def spatial_fit_record(ranks):
    """The record and checks of spatial_fit's ranks: every rank at step 2;
    rank 0 alone rendered and logged one picture set, whose target equals
    the one-process Trainer's and whose warped ref0 and depth are within
    SPATIAL_PICTURE_RTOL rel L2 of its."""
    fits = [r["fit"] for r in ranks]
    got = fits[0]["pictures"][0] if fits[0]["pictures"] else None
    ref = fits[0]["one_process"]
    names = ["depth_", "tgt_", "warp_"]
    record = {"steps": [f["step"] for f in fits], "seconds": [f["seconds"] for f in fits],
              "logged_images": [f["logged_images"] for f in fits],
              "pictures_per_rank": [len(f["pictures"]) for f in fits]}
    checks = [(all(f["step"] == 2 for f in fits), f"fit: steps {record['steps']}"),
              (record["pictures_per_rank"] == [1] + [0] * (len(fits) - 1)
               and len(fits[0]["logged_images"]) == 1
               and [n[:len(p)] for n, p in zip(fits[0]["logged_images"][0], names)] == names
               and not any(f["logged_images"] for f in fits[1:]),
               f"fit: pictures {record['pictures_per_rank']}, logged {record['logged_images']}")]
    if got is not None and ref is not None:
        record["tgt_equal"] = bool(np.array_equal(got[0], ref[0]))
        record["warped_rel_l2"] = rel_l2(torch.from_numpy(got[1]), torch.from_numpy(ref[1]))
        record["depth_rel_l2"] = rel_l2(torch.from_numpy(got[2]), torch.from_numpy(ref[2]))
        checks += [(record["tgt_equal"], "fit: rank 0's target picture differs"),
                   (record["warped_rel_l2"] <= SPATIAL_PICTURE_RTOL,
                    f"fit: warped picture rel L2 {record['warped_rel_l2']}"),
                   (record["depth_rel_l2"] <= SPATIAL_PICTURE_RTOL,
                    f"fit: depth picture rel L2 {record['depth_rel_l2']}")]
    return record, checks


def _mib(nbytes):
    return None if nbytes is None else nbytes / 2**20


def _to_cpu(tree):
    """Nested dicts and lists of tensors (and other values: a state dict's
    numbers) with every tensor copied to the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    if sys.argv[1:2] == ["--spatial-repeat"]:
        sys.exit(1 if spatial_repeat(int(sys.argv[2]), int(sys.argv[3])) else 0)
    if sys.argv[1:2] == ["--models"]:
        sys.exit(models_only())
    main()
