"""A closed serving loop: camera frames -> depth -> pseudo-LiDAR cloud
through the program's captured DepthToPointCloudPipeline.

Set-up writes the configuration's KITTI calibration under TMPDIR, builds
the program's depth model `model.name` from the keyword arguments
`model.kwargs` on the card without its own initialization and fills it
from the seed (core/weights.py), wraps it as cli.pipeline serves it
(`make_depth_fn` with the configuration's `serving` settings,
`PseudoLiDAR`, `DepthToPointCloudPipeline`), and makes `frames` decoded,
normalized
frames from the seed (core/synthetic.py). With `cameras` 1 a unit is one
frame through `process`; with 2 it is one rig step of two synchronized
frames (frames 2j and 2j + 1) through `process_batch`. Two calls warm the
unit's shape up: the first runs eagerly, the second captures the graph.

The window hands over the next unit as soon as the last one's clouds have
returned, until `seconds` have passed. A frame's latency runs from the
hand-off to the return of its compacted cloud (a rig step's frames share
the step's). The answers of the units that will be checked are copied
into buffers made at set-up. A traced run then profiles `trace_units`
more units.

Checked, after the window and once the program is freed: the units whose
index in the window is `r` modulo `check_stride` (r drawn from the seed),
up to `checked_frames` of them. For each of their frames:

- depth_tf32_gap: how far the served depth lies from the plain
  reference's (reference/nets/<model.name>.py on the same frame and
  weights, its outputs mapped to depth by reference/depth.py) computed in
  the precision the configuration states (cuDNN's TF32 on),
  ||d - d_tf32|| / ||d_tf32 - d_ref||, in units of how far TF32 alone
  moves the reference's full float32 depth d_ref (floored at TF32_FLOOR of
  ||d_ref||); the worst frame's. Against d_ref alone the bf16 path read
  2.9x TF32's on a seed (PERF.md);
- cloud_gap_m: the served cloud against the plain projector
  (reference/projector.py) applied to the served depth, in metres: the
  largest coordinate gap of a served point, or distance by which a served
  pixel lies outside the kept region (x >= 0, z < max_high) or a pixel
  left out lies inside it; float32 rounding moves a point near the
  region's edge across it by ~1e-5 m.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.core import device as dev
from portbench.core import spec
from portbench.core.flops import forward_macs
from portbench.core.outcome import Outcome, checks_from
from portbench.core.stats import percentile, rate
from portbench.core.synthetic import frames as make_frames
from portbench.core.trace import profile
from portbench.core.weights import fill
from portbench.reference.depth import served_depth
from portbench.reference.projector import backproject, camera

# depth_tf32_gap's least denominator, relative to the depth map's norm: where
# the device has no TF32 (the CPU) the TF32 reference equals the exact one;
# on the card TF32 moves the served depth of bts_densenet161 by some 1e-5 -
# 1e-4 of its norm (PERF.md)
TF32_FLOOR = 1e-6

def write_calib(directory: str, calib: Dict) -> None:
    """The KITTI calibration files the program's Calibration reads."""
    def row(values):
        return " ".join(repr(float(v)) for v in values)

    with open(os.path.join(directory, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"K_02: {row(calib['K_02'])}\nP_rect_02: {row(calib['P_rect_02'])}\n"
                f"R_rect_02: {row(calib['R_rect_02'])}\n")
    with open(os.path.join(directory, "calib_velo_to_cam.txt"), "w") as f:
        f.write(f"R: {row(calib['velo_to_cam_R'])}\nT: {row(calib['velo_to_cam_T'])}\n")
    with open(os.path.join(directory, "calib_imu_to_velo.txt"), "w") as f:
        f.write(f"R: {row(calib['imu_to_velo_R'])}\nT: {row(calib['imu_to_velo_T'])}\n")


def cloud_gap(served: np.ndarray, depth: np.ndarray, calib: Dict, max_high: float,
              device: torch.device) -> float:
    """The served cloud's largest error in metres against the plain
    projector on the served depth (module docstring): each served point is
    taken back to its pixel through the camera (the pixels must come in
    order, each once); the error is the largest of a point's coordinate
    gap, how far outside the kept region a served pixel lies, and how far
    inside it a pixel lies that was not served. Where the points cannot be
    taken back to pixels, _in_order_gap."""
    d = torch.as_tensor(depth, device=device)
    height, width = d.shape
    velo, inside = backproject(d, calib, max_high)
    got = torch.as_tensor(np.asarray(served), device=device, dtype=torch.float64)
    if got.ndim != 2 or got.shape[1] != 4 or not torch.isfinite(got).all():
        return math.inf
    if not len(got):
        return float(torch.clamp(inside.max(), min=0.0))
    proj, to_cam = camera(calib, device)
    cam = to_cam[:3, :3] @ got[:, :3].T + to_cam[:3, 3:]
    f_u, f_v = proj[0, 0], proj[1, 1]
    z = cam[2]
    u = torch.round((cam[0] - proj[0, 3] / (-f_u)) * f_u / z + proj[0, 2])
    v = torch.round((cam[1] - proj[1, 3] / (-f_v)) * f_v / z + proj[1, 2])
    pixel = (v * width + u).long()
    if not (((u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)).all()
            and (pixel[1:] > pixel[:-1]).all()):
        return _in_order_gap(got, velo[:, inside >= 0].T)
    coord = (got[:, :3] - velo[:, pixel].T).abs().max()
    intensity = got[:, 3].abs().max()
    outside = torch.clamp(-inside[pixel], min=0.0).max()
    dropped = inside.clone()
    dropped[pixel] = -math.inf
    missing = torch.clamp(dropped.max(), min=0.0)
    return float(torch.stack([coord, intensity, outside, missing]).max())


def _in_order_gap(got: torch.Tensor, kept: torch.Tensor) -> float:
    """Where served points cannot be taken back to pixels: the largest
    coordinate gap between the served points and the reference's kept
    points taken in order, over as many as both have, or the distance of
    the first point one of them has beyond the other's end."""
    n = min(len(got), len(kept))
    gap = float((got[:n, :3] - kept[:n]).abs().max()) if n else 0.0
    if len(got) != len(kept):
        extra = got[n, :3] if len(got) > n else kept[n]
        gap = max(gap, float(extra.abs().max()))
    return gap


def reference_model(config: Dict) -> torch.nn.Module:
    """The plain reference of the configuration's model, built on the
    current default device."""
    model, size = config["model"], config["input"]
    net = spec.reference_net(model["name"])
    return net.build(model.get("kwargs", {}), (size["height"], size["width"]))


def _answer_slots(results, count: int) -> List:
    """Buffers, made at set-up, for the answers of `count` checked units
    (depth, and room for every pixel's point, a camera): the window copies
    a checked unit's answers into them, so that which units are checked,
    which the seed draws, leaves the host's heap as it leaves it for every
    other seed."""
    return [[(np.empty_like(r.depth), np.empty((r.depth.size, r.points.shape[1]),
                                               r.points.dtype)) for r in results]
            for _ in range(count)]


def _keep(results, slot) -> List:
    """The checked unit's answers, copied into its slot; an answer of
    another shape or type than the slot's is kept as it came."""
    kept = []
    for r, (depth, points) in zip(results, slot):
        d, p = np.asarray(r.depth), np.asarray(r.points)
        if (d.shape != depth.shape or d.dtype != depth.dtype or p.dtype != points.dtype
                or p.shape[1:] != points.shape[1:] or len(p) > len(points)):
            kept.append((d, p))
            continue
        depth[...] = d
        points[:len(p)] = p
        kept.append((depth, points[:len(p)]))
    return kept


def model_flops_per_frame(config: Dict) -> float:
    size = config["input"]
    macs = forward_macs(lambda: reference_model(config), (1, 3, size["height"], size["width"]))
    return 2 * macs


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False) -> Outcome:
    """One run of the cell (module docstring). control=True serves through
    the program's paths in the precision below the configuration's: the
    depth model in bf16 (the configuration's is float32 with cuDNN's TF32)
    and the projector's matmuls in TF32 (the configuration's are float32)."""
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import MODEL_REGISTRY
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_fn
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
        DepthToPointCloudPipeline,
    )
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR

    config, traffic = cell.config, cell.traffic
    model_cfg, size, serving = config["model"], config["input"], config["serving"]
    cameras = traffic["cameras"]
    dev.apply_flags(config["flags"])
    if control:
        # the precision below the configuration's in the projector too:
        # its float32 matmuls in TF32
        torch.backends.cuda.matmul.allow_tf32 = True
    with torch.device("meta"):
        model = MODEL_REGISTRY[model_cfg["name"]](**model_cfg.get("kwargs", {}))
    model = model.to_empty(device=device)
    fill({"depth": model}, seed, config["init"])
    with tempfile.TemporaryDirectory(prefix="portbench_calib_") as calib_dir:
        write_calib(calib_dir, config["calib"])
        projector = PseudoLiDAR(calib_dir, sparsity=serving["sparsity"],
                                max_high=serving["max_high"], device=device)
    precision = "bf16" if control else serving["precision"]
    pipeline = DepthToPointCloudPipeline(
        make_depth_fn(model, metric_output=serving["metric_output"],
                      min_depth=serving.get("min_depth"), max_depth=serving.get("max_depth"),
                      precision=precision),
        projector, device=device)
    frames = make_frames(traffic["frames"], size["height"], size["width"], seed, device)
    if cameras == 1:
        units = [frames[j] for j in range(len(frames))]
        call = pipeline.process
    else:
        units = [frames[j:j + cameras] for j in range(0, len(frames) - cameras + 1, cameras)]
        call = pipeline.process_batch
    for _ in range(2):
        warm = call(units[0])
    slots = _answer_slots(warm if cameras > 1 else [warm], traffic["checked_frames"])

    rng = np.random.default_rng(seed)
    offset = int(rng.integers(traffic["check_stride"]))
    kept: List = []
    latencies: List[float] = []
    dev.sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    done = 0
    while True:
        unit = done % len(units)
        t_hand = time.perf_counter()
        out = call(units[unit])
        t_back = time.perf_counter()
        latencies += [t_back - t_hand] * cameras
        if done % traffic["check_stride"] == offset and len(kept) < traffic["checked_frames"]:
            results = out if cameras > 1 else [out]
            kept.append((unit, _keep(results, slots[len(kept)])))
        done += 1
        if t_back - t0 >= seconds:
            break
    elapsed = t_back - t0
    peak = dev.peak_reserved(device)
    outcome = Outcome(
        end_to_end={"serve_frames_per_s": rate(done * cameras, elapsed),
                    "serve_latency_p95_ms": 1e3 * percentile(latencies, 95.0),
                    "peak_reserved_gib": peak / 2 ** 30, "setup_s": setup_s},
        attempted=done * cameras, failed=0, peak_bytes=peak)
    if trace:
        outcome.slice = profile(lambda k: call(units[(done + k) % len(units)]),
                                traffic["trace_units"], tempfile.gettempdir(), device)
        outcome.facts.update(
            pool_bytes=dev.pool_bytes(device, pipeline.graphs.pool if pipeline.graphs else None),
            flops_per_unit=model_flops_per_frame(config) * cameras,
            shapes={"batch": cameras, "height": size["height"], "width": size["width"]})
    del pipeline, model, call
    dev.free(device)
    outcome.checks = checks_from(check(config, seed, units, kept, device), cell.limits)
    return outcome


def check(config: Dict, seed: int, units, kept, device: torch.device) -> Dict[str, float]:
    """depth_tf32_gap and cloud_gap_m over the kept units (module
    docstring)."""
    if not kept:
        return {}
    with torch.device(device):
        reference = reference_model(config)
    fill({"depth": reference}, seed, config["init"])
    reference.eval()
    depth_gap = cloud = 0.0
    max_high = config["serving"]["max_high"]
    for unit, results in kept:
        frame = np.asarray(units[unit])
        x = torch.as_tensor(frame, device=device).reshape(-1, *frame.shape[-3:])
        x = x.permute(0, 3, 1, 2).contiguous()
        expected = {}
        for stated in (True, False):
            if stated:
                dev.apply_flags(config["flags"])
            else:
                dev.reference_flags()
            with torch.no_grad():
                expected[stated] = served_depth(reference(x), config["serving"]).double()
        for (depth, points), tf32, exact in zip(results, expected[True], expected[False]):
            got = torch.as_tensor(depth, device=device, dtype=torch.float64)
            if got.shape != exact.shape:
                return {"depth_tf32_gap": math.inf, "cloud_gap_m": math.inf}
            scale = torch.clamp(torch.linalg.vector_norm(tf32 - exact),
                                min=TF32_FLOOR * torch.linalg.vector_norm(exact))
            depth_gap = max(depth_gap, float(torch.linalg.vector_norm(got - tf32) / scale))
            cloud = max(cloud, cloud_gap(points, depth, config["calib"], max_high, device))
    return {"depth_tf32_gap": depth_gap, "cloud_gap_m": cloud}
