"""Odometry export: the pose net's trajectory over raw KITTI drives.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/odometry.py (main
:22-183). Runs the pose net (the latest checkpoint of the config's model
when there is one) over every sliding window of the drives under
datasets.path (data/kitti.UnSupStackedDataset), integrates the (t -> t+1)
relative poses into camera-to-world poses and writes them in the KITTI
odometry format, one file a drive (suffixed with the drive's name when
there are several). `--gt-out` also writes the OXTS trajectory: camera k
in camera 0's frame, C @ inv(T_w_0) @ T_w_k @ inv(C) in float64 — not an
integration of relative vectors. Prints the pose metrics of every window
against its OXTS odometry.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.odometry \\
      --config configs/basic_config.yaml --out poses.txt \\
      [--gt-out gt_poses.txt] [--max-windows N] [--device cpu]

The windows go through the pose net `action.batch_size` at a time; the
last batch of a drive is not padded (nothing is compiled per shape).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pose-net odometry export")
    parser.add_argument("--config", default="configs/basic_config.yaml")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint dir override (latest epoch loads)")
    parser.add_argument("--out", required=True,
                        help="predicted trajectory (KITTI odometry format)")
    parser.add_argument("--gt-out", default=None,
                        help="also write the OXTS ground-truth trajectory")
    parser.add_argument("--max-windows", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs on the CPU)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from unsupervised_pseuso_lidar_tpu_torch.data.kitti import UnSupStackedDataset, collate
    from unsupervised_pseuso_lidar_tpu_torch.eval.pose import pose_errors, pose_forward
    from unsupervised_pseuso_lidar_tpu_torch.eval.trajectory import (
        integrate_relative_poses,
        kitti_odometry_lines,
        relative_matrices,
    )
    from unsupervised_pseuso_lidar_tpu_torch.geometry.oxts import (
        load_oxts_packets_and_poses,
    )
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
        Trainer,
        batch_to_device,
        normalize_uint8_batch,
    )
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_config(args.config)
    config.action.from_scratch = False  # restore the latest checkpoint
    if args.checkpoint:
        config.action.checkpoint_dir = args.checkpoint

    dataset = UnSupStackedDataset(config)
    if len(dataset) == 0:
        raise SystemExit(
            f"error: no sliding windows under {config.datasets.path!r} "
            "(expected <root>/<date>/<drive>_sync/image_02/data/*.png)"
        )
    trainer = Trainer(config, dataset=dataset, device=device)
    pose_model = trainer.state.pose_model.eval()

    # the sample list runs across drives: one trajectory a drive
    by_drive: dict = {}
    for i, sample in enumerate(dataset.samples):
        drive = os.path.dirname(os.path.dirname(os.path.dirname(sample.tgt)))
        by_drive.setdefault(drive, []).append(i)
    batch_size = config.action.batch_size

    @torch.no_grad()
    def predict_drive(indices):
        rel_pred, rel_gt = [], []
        for start in range(0, len(indices), batch_size):
            batch = collate([dataset.load_sample(i, with_groundtruth=False)
                             for i in indices[start : start + batch_size]])
            poses = pose_forward(pose_model,
                                 normalize_uint8_batch(batch_to_device(batch, device)))
            rel_pred.append(poses.float().cpu().numpy())  # [b, 2, 6]
            rel_gt.append(batch["oxts"])
        return np.concatenate(rel_pred, axis=0), np.concatenate(rel_gt, axis=0)

    def exact_gt_trajectory(indices):
        # window k is centred on frame k+1: frame 0 is window 0's ref0,
        # frames 1..N the targets, frame N+1 the last window's ref1
        samples = [dataset.samples[i] for i in indices]
        oxts_files = ([samples[0].oxts[1]] + [s.oxts[0] for s in samples]
                      + [samples[-1].oxts[2]])
        world = load_oxts_packets_and_poses(oxts_files)
        c = np.asarray(samples[0].imu_to_cam, np.float64)
        c_inv = np.linalg.inv(c)
        t0_inv = np.linalg.inv(np.asarray(world[0], np.float64))
        return np.stack([c @ t0_inv @ np.asarray(t, np.float64) @ c_inv for t in world])

    def world_trajectory(rel, mode):
        # rel[:, 1] chains (k+1 -> k+2) from camera 1; window 0's first
        # transform (frame 1 -> frame 0) is camera 1's pose in frame 0
        chain = integrate_relative_poses(rel[:, 1], mode=mode)  # [N+1, 4, 4]
        t10 = relative_matrices(rel[:1, 0], mode=mode)[0]
        world = np.einsum("ij,njk->nik", t10, chain)
        return np.concatenate([np.eye(4)[None], world], axis=0)

    def out_path(base, drive, multi):
        if not multi:
            return base
        stem, ext = os.path.splitext(base)
        return f"{stem}_{os.path.basename(drive)}{ext or '.txt'}"

    def write(path, lines):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    multi = len(by_drive) > 1
    metrics: dict = {"drives": len(by_drive), "frames": 0}
    all_pred, all_gt = [], []
    for drive, indices in sorted(by_drive.items()):
        if args.max_windows:
            indices = indices[: args.max_windows]
        pred, gt = predict_drive(indices)
        all_pred.append(pred)
        all_gt.append(gt)
        lines = kitti_odometry_lines(world_trajectory(pred, "axis_angle"))
        write(out_path(args.out, drive, multi), lines)
        metrics["frames"] += len(lines)
        if args.gt_out:
            write(out_path(args.gt_out, drive, multi),
                  kitti_odometry_lines(exact_gt_trajectory(indices)))

    errors = pose_errors(torch.from_numpy(np.concatenate(all_pred, axis=0)),
                         torch.from_numpy(np.concatenate(all_gt, axis=0)))
    metrics.update({f"pose_{k}": float(v) for k, v in errors.items()})
    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                      for k, v in metrics.items()}, indent=2))
    return metrics


if __name__ == "__main__":
    main()
