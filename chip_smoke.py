"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (into
build/torch_ext/), holds the division helper of kernels B and C
(ops/cuda/div3.cuh) against the IEEE division over all 2^32 fp32 bit
patterns, holds each kernel against its plain PyTorch version at
the shapes of the production configuration (configs/tpu_v5e.yaml:
DispResNet-18 + PoseNet, 640x192, batch 12, bf16 models, fp32 loss),
then drives the port's entry points with seeded random weights:

  serve       DepthToPointCloudPipeline.run over 20 synthetic frames
  validation  3 steps of the eval step (make_eval_step), whose photometric
              objective launches kernel A once and kernel B twice a step
  train       Trainer.run_epoch over 3 steps (after 1 warm-up step), each
              launching A and its grid gradient A' once, B twice and the
              SSIM backward C once

The kernel phases hold A, A' (kernel_a_bwd), B and C (kernel_c) against
their plain versions on the main path's inputs, and time each kernel, its
plain version and the library call (where one exists) on the card: CUDA
events around 20 back-to-back calls, divided by 20, the median of 5 such
runs (`ms`); `ms_per_call_host_incl` is the older measure, events around
one call, which also counts the host's work before the launch.

Every phase prints one JSON line; every check that fails raises, and the
script exits non-zero. Before the last line it prints the per-kernel
record ({"kernels": [...]}) and the card's name and power limit as
nvidia-smi reports them; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the rest of the repository beside it,
it exits non-zero and prints no result.
"""

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import (
    SyntheticTripletDataset,
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
)
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import (
    photometric_map,
    photometric_map_bwd,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
    DepthToPointCloudPipeline,
    depth_fn_from_model,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
    PseudoLiDAR,
)
from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer, make_eval_step
from unsupervised_pseuso_lidar_tpu_torch.utils.device import card, device_time_ms
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import div
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import (
    normalize_image,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "tpu_v5e.yaml")
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
TRAIN_STEPS = 3
# pseudo-LiDAR on the card vs the CPU: points in meters (fp32, depths up
# to 100 m), and the share of pixels whose crop decision may flip at the
# crop's edges through rounding
POINTS_ATOL = 1e-3
POINTS_MASK_MISMATCH = 1e-3


def emit(record):
    print(json.dumps(record), flush=True)


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
    to the image, the real velodyne->camera transform."""
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
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n")


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

    # the main path's kernel inputs, from a real validation step: the
    # stacked warp jobs [ref0->tgt, ref1->tgt, tgt->ref0] and their coords
    inputs = step.loss_inputs(batches[0])
    d_tgt = normalize_depth(disp_to_depth(inputs["disparities"][0][0]))[:, 0]
    d_ref0 = normalize_depth(disp_to_depth(inputs["disparities"][1][0]))[:, 0]
    t0_, t1_ = pose_matrix(inputs["poses"][:, 0]), pose_matrix(inputs["poses"][:, 1])
    transform = torch.cat([t0_, t1_, invert_pose(t0_)], dim=0)
    coords = warp_coords(torch.cat([d_tgt, d_tgt, d_ref0], dim=0), transform,
                         inputs["intrinsics"].repeat(3, 1, 1)).contiguous()
    src = torch.cat([inputs["refs"][0], inputs["refs"][1], inputs["tgt"]]).contiguous()
    target = torch.cat([inputs["tgt"], inputs["tgt"], inputs["refs"][0]]).contiguous()
    jobs = src.shape[0]
    gpu_gen = torch.Generator(device=device).manual_seed(SEED)
    # ~10% of the random samples fall outside [-1, 1]^2
    random_coords = (torch.rand(coords.shape, generator=gpu_gen, device=device)
                     * 2.0 - 1.0) * 1.05
    out_of_frame = float((random_coords.abs() > 1).any(-1).float().mean())

    # 3. kernel A vs its plain version (and F.grid_sample as a cross-check)
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
    pixels = jobs * height * width
    warp_bound = bound(pixels * (8 + 12 + 12), pixels * WARP_OPS_PER_PIXEL)
    warp_rec = {
        "name": "warp_bilinear_fwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/warp_bilinear.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/warp.py:535",
        "max_abs_err": warp_err,
        "ms": device_time_ms(lambda: kernels.warp_bilinear_fwd(src, coords)),
        "plain_ms": device_time_ms(lambda: grid_sample(src, coords)),
        "bound_ms": warp_bound[0], "bound_by": warp_bound[1],
        "library_ms": device_time_ms(lambda: F.grid_sample(
            src, coords, mode="bilinear", padding_mode="zeros",
            align_corners=True)),
        "ms_per_call_host_incl": time_ms_per_call(
            lambda: kernels.warp_bilinear_fwd(src, coords)),
    }
    emit({"phase": "kernel_a", "shape": list(src.shape),
          "random_out_of_frame": out_of_frame,
          "max_abs_err_vs_F_grid_sample": lib_err,
          **{k: warp_rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "library_ms",
                                       "ms_per_call_host_incl")}})

    # 4. kernel B vs its plain version on the main path's two calls: the
    # identity pair (2B jobs) and the warped stack (3B jobs)
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
    ssim_rec = {
        "name": "ssim_fwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/ssim.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py:76",
        "max_abs_err": ssim_err, "ms": ssim_ms, "plain_ms": ssim_plain_ms,
        "bound_ms": ssim_bound[0], "bound_by": ssim_bound[1],
        "library_ms": None, "ms_per_call_host_incl": ssim_host_ms,
    }
    emit({"phase": "kernel_b", "max_abs_err": ssim_err, "calls": ssim_times,
          "ms_per_step": ssim_ms, "bound_ms_per_step": ssim_bound[0]})

    # 5. serve: frames -> depth -> pseudo-LiDAR through the pipeline
    frames = [normalize_image(img.astype(np.float32) / 255.0)
              for b in batches[:2] for img in b["tgt"]][:20]
    with tempfile.TemporaryDirectory() as calib_dir:
        write_calib(calib_dir, height, width)
        pipeline = DepthToPointCloudPipeline(
            depth_fn_from_model(depth_model, config.action.precision),
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
          "launches": serve_launches})

    # 6. validation: the main path; launches counted over exactly these steps
    step(batches[1])  # warm-up
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

    # 7. kernel A' vs its plain version on the path's coords and the
    # random ones, with a random cotangent
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
    warp_bwd_rec = {
        "name": "warp_bilinear_bwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/warp_bilinear.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/warp.py:535 "
                    "(with_taps=True, _fwd :551 + _bwd :569)",
        "max_abs_err": warp_bwd_err,
        "ms": device_time_ms(lambda: kernels.warp_bilinear_bwd_grid(src, coords, g_warp)),
        "plain_ms": device_time_ms(lambda: grid_sample_grad_grid(src, coords, g_warp)),
        "bound_ms": warp_bwd_bound[0], "bound_by": warp_bwd_bound[1],
        # the grid-only gradient of the library's sampler
        "library_ms": device_time_ms(lambda: torch.autograd.grad(
            lib_out, lib_grid, g_warp, retain_graph=True)),
        "ms_per_call_host_incl": time_ms_per_call(
            lambda: kernels.warp_bilinear_bwd_grid(src, coords, g_warp)),
    }
    emit({"phase": "kernel_a_bwd", "shape": list(src.shape),
          **{k: warp_bwd_rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "library_ms",
                                           "ms_per_call_host_incl")}})

    # 8. kernel C vs its plain version on the warped stack (blend 0.85, the
    # main path's setting), dx only (the main path: the target is data) and
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
    ssim_bwd_rec = {
        "name": "ssim_bwd", "route": "cuda",
        "source": "unsupervised_pseuso_lidar_tpu_torch/ops/cuda/ssim_bwd.cu",
        "replaces": "unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py:235",
        "max_abs_err": ssim_bwd_err,
        "ms": device_time_ms(lambda: kernels.ssim_bwd(warped, target, g_ssim, 0.85, True, False)),
        "plain_ms": device_time_ms(lambda: photometric_map_bwd(warped, target, g_ssim, 0.85,
                                                        True, False)),
        "bound_ms": ssim_bwd_bound[0], "bound_by": ssim_bwd_bound[1],
        "library_ms": None,  # no single PyTorch call computes it
        "ms_per_call_host_incl": time_ms_per_call(
            lambda: kernels.ssim_bwd(warped, target, g_ssim, 0.85, True, False)),
    }
    emit({"phase": "kernel_c", "shape": list(warped.shape),
          "ms_dx_dy": device_time_ms(lambda: kernels.ssim_bwd(warped, target, g_ssim, 0.85)),
          **{k: ssim_bwd_rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "ms_per_call_host_incl")}})

    # 9. train: the main path of this slice, Trainer.run_epoch at the
    # config's full width and batch
    train_launches = train_phase(config, device, batch_size, height, width)

    warp_rec["launches"] = train_launches["warp_bilinear_fwd"]
    warp_bwd_rec["launches"] = train_launches["warp_bilinear_bwd"]
    ssim_rec["launches"] = train_launches["ssim_fwd"]
    ssim_bwd_rec["launches"] = train_launches["ssim_bwd"]
    emit({"kernels": [warp_rec, warp_bwd_rec, ssim_rec, ssim_bwd_rec]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


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
    torch.cuda.empty_cache()
    emit({"phase": "div3", "patterns": 1 << 32, "mismatches": mismatches,
          "first_mismatch_bits": first_bad, "nan_patterns": nans,
          "seconds": time.perf_counter() - t0})
    check(mismatches == 0, f"div3 disagrees with x / 3.0 on {mismatches} patterns")


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
    trainer.run_epoch(batches[:1])  # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: p.detach().clone() for k, p in params.items()}
    losses.clear()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = trainer.run_epoch(batches[1:])
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    event_ms = start.elapsed_time(end) / TRAIN_STEPS
    launches = dict(kernels.launch_counts)
    with_grad = {k for k, p in params.items()
                 if p.grad is not None and bool((p.grad != 0).any())}
    stale = sorted(k for k in with_grad if torch.equal(before[k], params[k]))
    unchanged = sorted(k for k in params if torch.equal(before[k], params[k]))
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())

    # the loss-side gradients: one step's fp32 loss inputs as leaves, the
    # training objective on the card (kernels) and on the CPU (plain
    # versions)
    act = config.action
    inputs = trainer.eval_step.loss_inputs(batches[1])

    def loss_grads(inp):
        leaves = [d.clone().requires_grad_() for d in
                  (inp["disparities"][0][0], inp["disparities"][1][0], inp["poses"])]
        reproj, smooth = total_loss(
            inp["tgt"], inp["refs"], [[leaves[0]], [leaves[1]]], leaves[2],
            inp["intrinsics"], mode=act.loss_mode, smooth_weight=act.smooth_weight,
            smooth_on=act.smooth_on, depth_norm=act.depth_norm,
            min_bidirectional=act.min_bidirectional,
        )
        return torch.autograd.grad(reproj + smooth, leaves)

    on_gpu = loss_grads(inputs)
    on_cpu = loss_grads(_to_cpu(inputs))
    grad_rel = {name: rel_l2(a.cpu(), b) for name, a, b in
                zip(("disp_tgt", "disp_ref0", "poses"), on_gpu, on_cpu)}
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
    expected = {"warp_bilinear_fwd": TRAIN_STEPS, "warp_bilinear_bwd": TRAIN_STEPS,
                "ssim_fwd": 2 * TRAIN_STEPS, "ssim_bwd": TRAIN_STEPS}
    check(launches == expected, f"train launches {launches}, expected {expected}")
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
          f"train losses {losses}")
    check(finite, "a parameter is not finite after training")
    check(not stale, f"parameters with a gradient did not change: {stale}")
    check(max(grad_rel.values()) <= GRAD_REL_L2,
          f"loss gradients cuda vs cpu: rel L2 {grad_rel} > {GRAD_REL_L2}")
    return launches


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    main()
