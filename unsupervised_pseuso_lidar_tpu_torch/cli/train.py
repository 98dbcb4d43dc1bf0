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

`--profile DIR` traces the whole `fit` with torch.profiler
(utils/profiling.trace) into a `*.pt.trace.json` under DIR, which
Perfetto and TensorBoard open; keep the epochs short, since the profiler
holds every event in host memory. `--op-breakdown` then profiles 3 calls
of the train step on one batch (2 more warm it up) and prints the ms a
step by op family (utils/trace.op_breakdown: device time on the card, the
device's busy share beside it); the result is kept as
`trainer.op_breakdown`. The port runs on one card (`--mesh` above 1
raises).
"""

from __future__ import annotations

import argparse
import contextlib


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
                        help="capture a torch.profiler trace of the whole fit "
                        "(every epoch: keep them few) into DIR")
    parser.add_argument("--op-breakdown", action="store_true",
                        help="after training, print per-op-family device "
                        "ms/step of one train step (utils/trace.py)")
    args = parser.parse_args(argv)

    if args.mesh > 1:
        raise ValueError("--mesh: the port trains on one card")

    from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
    from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger
    from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import trace

    config = load_config(args.config)
    if args.epochs is not None:
        config.action.num_epochs = args.epochs
    if args.batch_size is not None:
        config.action.batch_size = args.batch_size
    device = resolve_device(args.device)
    profile_ctx = (trace(args.profile, device=device) if args.profile
                   else contextlib.nullcontext())

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
        with profile_ctx:
            trainer.fit(make_train_iter=lambda epoch: prefetch_to_device(
                dataset.batches(epoch), device=trainer.device))
        if args.op_breakdown:
            trainer.op_breakdown = _op_breakdown_step(
                trainer, next(iter(dataset.batches(0))))
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

    with profile_ctx:
        trainer.fit(
            make_train_iter=lambda epoch: prefetch_to_device(
                dataset.batches(epoch_indices(epoch), batch_size, workers,
                                use_processes=procs, with_groundtruth=with_gt),
                device=trainer.device,
            ),
            make_val_iter=lambda: dataset.batches(val_idx, batch_size, workers),
        )
    if args.op_breakdown:
        # the first batch of the training indices, as in JAX
        trainer.op_breakdown = _op_breakdown_step(trainer, next(iter(dataset.batches(
            train_idx[:batch_size], batch_size, workers, with_groundtruth=with_gt))))
    return trainer


def _op_breakdown_step(trainer, batch):
    """Print and return the per-op-family device time of one train step
    (utils/trace.op_breakdown over 3 calls after 2 of warm-up) on `batch`,
    placed on the trainer's device first as the training loop's batches
    are. The batch keeps its ground truth when the supervised term reads
    it, so the profiled step is the trained one. The calls train: they
    advance the optimizer and the step count."""
    import torch

    from unsupervised_pseuso_lidar_tpu_torch.utils.trace import op_breakdown

    if not trainer.config.action.supervised_weight:
        batch = {k: v for k, v in batch.items() if k != "groundtruth"}
    device_batch = {k: torch.as_tensor(v).to(trainer.device) for k, v in batch.items()}
    return op_breakdown(lambda: trainer.train_step(device_batch), steps=3)


if __name__ == "__main__":
    main()
