"""Streaming pseudo-LiDAR pipeline entry point.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/pipeline.py (main
:33-195): replay KITTI image directories (one per camera of a rig), run
the depth model and the projector on each frame (a rig step as one
batch), optionally save each cloud, and print one JSON line of stats.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.pipeline \\
      --images KITTI/2011_09_26/..._sync/image_02/data [more dirs] \\
      --calib KITTI/2011_09_26 [--config configs/tpu_v5e.yaml \\
      --torch-checkpoint x.pth | --checkpoint DIR] [--rate 10] \\
      [--queue-size 1] [--save-dir out/ --format npy|bin] [--device cpu]

Arguments may come from a file, one '--flag value' per line (the
reference's pseudo-lidar/config_test.txt layout): `@args.txt`. Without
--config the model is --model (DispResNet, DispNetS, StnDispNet or
BtsModel) at its seeded init. A BtsModel serves its last output, metric
depth (the reference ROS node's model); the others their finest
disparity through disp_to_depth.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time


class _AtFileParser(argparse.ArgumentParser):
    """@file arguments in the reference's layout, '--flag value' per line:
    argparse's own reader takes a whole line as ONE token, so split it on
    whitespace."""

    def convert_arg_line_to_args(self, arg_line):
        return arg_line.split()


def main(argv=None):
    parser = _AtFileParser(description="camera -> depth -> pseudo-LiDAR",
                           fromfile_prefix_chars="@")
    parser.add_argument("--images", required=True, nargs="+",
                        help="directory of PNG frames; several directories "
                        "make a multi-camera rig (each step batches all "
                        "cameras into one forward)")
    parser.add_argument("--calib", required=True, help="KITTI calib directory")
    parser.add_argument("--model", default="DispResNet",
                        choices=["DispResNet", "DispNetS", "StnDispNet", "BtsModel"])
    parser.add_argument("--config", default=None,
                        help="training config: serve ITS depth model with its "
                        "serving weights (see --checkpoint)")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint directory (with --config; default: the "
                        "config's checkpoint path)")
    parser.add_argument("--torch-checkpoint", default=None,
                        help="reference .pth (or .npz) weights (with --config)")
    parser.add_argument("--height", type=int, default=192)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--rate", type=float, default=0.0,
                        help="replay rate in Hz (0 = as fast as possible; the "
                        "reference pipeline runs at 10)")
    parser.add_argument("--sparsity", type=int, default=0)
    parser.add_argument("--queue-size", type=int, default=1,
                        help="input queue depth; 1 = the reference ROS nodes' "
                        "latest-wins semantics (stale frames are dropped under "
                        "load), larger for lossless replay")
    parser.add_argument("--save-dir", default=None, help="save each cloud here")
    parser.add_argument("--format", default="npy", choices=["npy", "bin"],
                        help="cloud file format: npy, or bin = raw float32 "
                        "x/y/z/intensity rows (the KITTI velodyne format 3D "
                        "detectors read)")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without one)")
    args = parser.parse_args(argv)

    import torch

    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_fn
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
        DepthToPointCloudPipeline,
        FileImageSource,
    )
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
        PseudoLiDAR,
        save_cloud,
    )
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    precision = "fp32"
    if args.config:
        from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import load_serving_weights
        from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
        from unsupervised_pseuso_lidar_tpu_torch.train.trainer import create_train_state

        config = load_config(args.config)
        state = create_train_state(
            config, torch.Generator().manual_seed(config.action.random_seed), device=device
        )
        source = load_serving_weights(config, state, torch_checkpoint=args.torch_checkpoint,
                                      checkpoint=args.checkpoint)
        model, precision = state.depth_model, config.action.precision
        model_name = config.model.depth.name
        print(f"serving {model_name} weights from {source}")
    else:
        if args.checkpoint or args.torch_checkpoint:
            raise SystemExit("--checkpoint/--torch-checkpoint need --config "
                             "(to know the model architecture)")
        model_name = args.model
        model = build_model(model_name, torch.Generator().manual_seed(0), device=device,
                            image_shape=(args.height, args.width))

    pipeline = DepthToPointCloudPipeline(
        make_depth_fn(model, metric_output=model_name == "BtsModel", precision=precision),
        PseudoLiDAR(args.calib, sparsity=args.sparsity, device=device), device=device,
    )
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    multi = len(args.images) > 1
    stats = {"frames": 0, "points_total": 0}

    def on_result(result):
        stats["frames"] += 1
        stats["points_total"] += result.points.shape[0]
        if args.save_dir:
            stem = (f"cloud_cam{result.stream_index}_{result.frame_index:06d}"
                    if multi else f"cloud_{result.frame_index:06d}")
            save_cloud(os.path.join(args.save_dir, f"{stem}.{args.format}"), result.points)

    def frames_for(image_dir):
        frames = iter(FileImageSource(image_dir, rate_hz=args.rate or None,
                                      size_hw=(args.height, args.width)))
        if args.max_frames:
            frames = itertools.islice(frames, args.max_frames)
        return frames

    t0 = time.perf_counter()
    if multi:
        processed = pipeline.run_multi([frames_for(d) for d in args.images], on_result,
                                       queue_size=args.queue_size)
    else:
        processed = pipeline.run(frames_for(args.images[0]), on_result,
                                 queue_size=args.queue_size)
    dt = time.perf_counter() - t0
    out = {
        "frames": processed,
        "streams": len(args.images),
        "seconds": round(dt, 3),
        "hz": round(processed / dt, 2) if dt else None,
        "avg_points_per_cloud": round(stats["points_total"] / max(stats["frames"], 1)),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
