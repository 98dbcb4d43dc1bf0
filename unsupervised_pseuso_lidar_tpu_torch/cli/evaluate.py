"""Evaluation entry point: KITTI depth (and pose) metrics over a split.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/evaluate.py (main
:18-88). Restores the latest checkpoint of the config's model when there
is one, runs the validation step over every sample of the split
(drop_last off, so the metrics cover the whole split whatever the batch
size) and prints the mean metrics as JSON.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.evaluate \\
      --config configs/basic_config.yaml [--split FILE] [--checkpoint DIR] \\
      [--max-batches N] [--median-scale] [--protocol eigen] \\
      [--pose-metrics] [--velo-gt] [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="Eigen-split depth evaluation")
    parser.add_argument("--config", default="configs/basic_config.yaml")
    parser.add_argument("--split", default=None, help="override split file")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint dir override (latest epoch loads)")
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--median-scale", action="store_true",
                        help="median-scale predictions to the ground truth "
                        "before the metrics (monocular depth has a global "
                        "scale ambiguity)")
    parser.add_argument("--protocol", default=None, choices=("none", "eigen"),
                        help="'eigen': the KITTI Eigen-split monocular "
                        "protocol (Garg crop, ground truth in (1e-3, 80) m, "
                        "per-image median scaling)")
    parser.add_argument("--pose-metrics", action="store_true",
                        help="also evaluate the pose net against the split's "
                        "OXTS odometry (snippet ATE, scaled and raw, and the "
                        "geodesic rotation error)")
    parser.add_argument("--velo-gt", action="store_true",
                        help="rasterize sparse ground truth from the raw "
                        "velodyne_points/*.bin scans for split lines without "
                        "an annotated-depth column")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)

    from unsupervised_pseuso_lidar_tpu_torch.data.kitti import UnSupKittiDataset
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_config(args.config)
    if args.split:
        config.datasets.split = args.split
    config.action.from_scratch = False  # restore the latest checkpoint
    if args.checkpoint:
        config.action.checkpoint_dir = args.checkpoint
    if args.median_scale:
        config.action.eval_median_scale = True
    if args.protocol is not None:
        config.action.eval_protocol = args.protocol
    if args.velo_gt:
        config.datasets.velo_gt = True
    if args.pose_metrics:
        config.action.eval_pose = True

    dataset = UnSupKittiDataset(config)
    trainer = Trainer(config, dataset=dataset, device=device)
    batch_size = config.action.batch_size
    indices = list(range(len(dataset)))
    if args.max_batches:
        indices = indices[: args.max_batches * batch_size]
    metrics = trainer.validate(
        dataset.batches(indices, batch_size, config.action.num_workers,
                        drop_last=False)
    )
    print(json.dumps({k: round(v, 5) for k, v in metrics.items()}, indent=2))
    return metrics


if __name__ == "__main__":
    main()
