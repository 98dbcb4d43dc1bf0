"""Training entry point.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/train.py (main :16-137):
load a YAML config, apply the command-line overrides, build the Trainer
and fit, a checkpoint per epoch; `from_scratch: False` in the config
resumes from the latest one.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.train \\
      --config configs/basic_config.yaml --synthetic [--epochs N] \\
      [--batch-size B] [--synthetic-batches N] [--device cpu]

The port runs on one card (`--mesh` above 1 raises). `--profile` and
`--op-breakdown` wait for utils/profiling and utils/trace; training on
KITTI waits for the host-data modules (data/kitti.py and its loaders): both
raise NotImplementedError. `--synthetic` trains on the synthetic scene
(data/synthetic.py), `--synthetic-batches` batches an epoch (50, as in the
JAX CLI).
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
    if not args.synthetic:
        raise NotImplementedError(
            "training on KITTI needs the host-data modules (data/kitti.py, "
            "data/splits.py, the image loaders), which are not ported yet; "
            "pass --synthetic"
        )

    from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
    from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import (
        SyntheticTripletDataset,
    )
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer
    from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger

    config = load_config(args.config)
    if args.epochs is not None:
        config.action.num_epochs = args.epochs
    if args.batch_size is not None:
        config.action.batch_size = args.batch_size

    height, width = config.image_shape
    dataset = SyntheticTripletDataset(
        num_batches=args.synthetic_batches, batch_size=config.action.batch_size,
        height=height, width=width, uint8_images=True,
    )
    trainer = Trainer(config, dataset=dataset, log_fn=MetricLogger(config),
                      device=args.device)
    trainer.fit(make_train_iter=lambda epoch: prefetch_to_device(
        dataset.batches(epoch), device=trainer.device))
    return trainer


if __name__ == "__main__":
    main()
