"""Training entry point.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/train.py (main :16-137):
load a YAML config, apply the command-line overrides, build the Trainer
and fit, a checkpoint per epoch; `from_scratch: False` in the config
resumes from the latest one.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.train \\
      --config configs/basic_config.yaml [--synthetic] [--epochs N] \\
      [--batch-size B] [--synthetic-batches N] [--device cpu]

Without `--synthetic` it trains on the KITTI drives of the config's split
file (data/kitti.py): the split's samples are shuffled with
action.random_seed into training and validation indices
(action.split[1] validates), the training indices are permuted afresh
each epoch (seeded), and `action.num_workers` threads — or processes,
with `action.worker_type: process` — decode the batches. A missing split
file or calibration exits with the error. `--synthetic` trains on the
synthetic scene (data/synthetic.py), `--synthetic-batches` batches an
epoch (50, as in the JAX CLI).

The port runs on one card (`--mesh` above 1 raises). `--profile` and
`--op-breakdown` wait for utils/profiling and utils/trace and raise
NotImplementedError.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Unsupervised depth training")
    parser.add_argument("--config", default="configs/basic_config.yaml")
    parser.add_argument("--mesh", type=int, default=0,
                        help="data-parallel devices (0 or 1: the one card)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on the synthetic scene (no KITTI needed)")
    parser.add_argument("--synthetic-batches", type=int, default=50,
                        help="batches an epoch of the synthetic scene")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="not ported yet (utils/profiling)")
    parser.add_argument("--op-breakdown", action="store_true",
                        help="not ported yet (utils/trace)")
    args = parser.parse_args(argv)

    if args.mesh > 1:
        raise ValueError("--mesh: the port trains on one card")
    if args.profile or args.op_breakdown:
        raise NotImplementedError(
            "--profile / --op-breakdown: utils/profiling and utils/trace are "
            "not ported yet"
        )

    from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
    from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger

    config = load_config(args.config)
    if args.epochs is not None:
        config.action.num_epochs = args.epochs
    if args.batch_size is not None:
        config.action.batch_size = args.batch_size
    device = resolve_device(args.device)

    if args.synthetic:
        from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import (
            SyntheticTripletDataset,
        )

        height, width = config.image_shape
        dataset = SyntheticTripletDataset(
            num_batches=args.synthetic_batches, batch_size=config.action.batch_size,
            height=height, width=width, uint8_images=True,
        )
        trainer = Trainer(config, dataset=dataset, log_fn=MetricLogger(config),
                          device=device)
        trainer.fit(make_train_iter=lambda epoch: prefetch_to_device(
            dataset.batches(epoch), device=trainer.device))
        return trainer

    import numpy as np

    from unsupervised_pseuso_lidar_tpu_torch.data.kitti import UnSupKittiDataset

    try:
        dataset = UnSupKittiDataset(config)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from e
    aug = config.datasets.augmentation
    train_idx, val_idx = dataset.train_val_indices(
        seed=config.action.random_seed, val_ratio=config.action.split[1],
        shuffle=aug.shuffle,
    )
    trainer = Trainer(config, dataset=dataset, log_fn=MetricLogger(config),
                      device=device)
    batch_size = config.action.batch_size
    workers = config.action.num_workers
    procs = config.action.worker_type == "process"
    # train batches carry ground truth only when the supervised term reads it
    with_gt = bool(config.action.supervised_weight)

    def epoch_indices(epoch):
        # a fresh seeded permutation each epoch, as in JAX
        if not aug.shuffle:
            return train_idx
        rng = np.random.default_rng(config.action.random_seed + 1_000_003 * (epoch + 1))
        return [int(i) for i in rng.permutation(train_idx)]

    trainer.fit(
        make_train_iter=lambda epoch: prefetch_to_device(
            dataset.batches(epoch_indices(epoch), batch_size, workers,
                            use_processes=procs, with_groundtruth=with_gt),
            device=trainer.device,
        ),
        make_val_iter=lambda: dataset.batches(val_idx, batch_size, workers),
    )
    return trainer


if __name__ == "__main__":
    main()
