"""Training entry point.

Counterpart of unsupervised_pseuso_lidar_tpu/cli/train.py (main :16-137):
load a YAML config, apply the command-line overrides, build the Trainer
and fit, a checkpoint per epoch; `from_scratch: False` in the config
resumes from the latest one.

  python -m unsupervised_pseuso_lidar_tpu_torch.cli.train \\
      --config configs/basic_config.yaml [--synthetic] [--epochs N] \\
      [--batch-size B] [--synthetic-batches N] [--device cpu] [--mesh N]

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
`trainer.op_breakdown`.

`--mesh N` trains data-parallel over N ranks, the global batch split
between them (parallel/; the step computes what one process computes on
the global batch, as JAX's mesh does). 0 is every local device:
torch.cuda.device_count() with `--device cuda`, 1 with `--device cpu`;
0 or 1 trains in this process, without a process group. Under torchrun
(`torchrun --nproc-per-node N -m unsupervised_pseuso_lidar_tpu_torch.cli.train
--mesh N`) each process joins torchrun's group as its rank, and N must
be its world size. Otherwise this process is rank 0 and spawns ranks
1..N-1: NCCL on cuda:0..N-1 (fewer CUDA devices than N raise), or gloo
with `--device cpu`. Rank 0 alone logs and writes checkpoints, and its
trainer is returned. Under NCCL each rank's train and eval steps run as
CUDA graphs that hold their collectives (train/graph.py), as they do
without a mesh; under gloo they run eagerly.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="Unsupervised depth training")
    parser.add_argument("--config", default="configs/basic_config.yaml")
    parser.add_argument("--mesh", type=int, default=0,
                        help="data-parallel ranks (0: every local device; "
                        "0 or 1: this process alone)")
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

    import torch

    from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed
    from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ranks = args.mesh or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if ranks <= 1:
        return _train(args, device)
    if all(v in os.environ for v in distributed.ENV_VARS):  # torchrun, or spawned
        return _train_as_rank(args, ranks, device)
    if device.type == "cuda" and torch.cuda.device_count() < ranks:
        raise ValueError(f"--mesh {ranks} needs {ranks} CUDA devices, found "
                         f"{torch.cuda.device_count()}")
    return _spawn_ranks(args, sys.argv[1:] if argv is None else list(argv), ranks, device)


def _train_as_rank(args, ranks, device, *group):
    """Join the process group (torchrun's environment, or `group`: the
    address, size and rank), train as this rank, leave the group."""
    import torch.distributed as dist

    from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed
    from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(*group, device=device)
    try:
        mesh = make_mesh(ranks, device=device)
        return _train(args, mesh.device, mesh)
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, ranks: int, port: int, argv) -> None:
    """A spawned rank: torchrun's environment for it, then main."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(ranks), RANK=str(rank), LOCAL_RANK=str(rank))
    main(argv)


def _spawn_ranks(args, argv, ranks: int, device):
    """Rank 0 in this process, ranks 1..N-1 spawned with `argv`; returns
    rank 0's trainer once every rank has finished. A failure of rank 0
    stops the others; a rank that fails makes rank 0's next collective
    fail (gloo) or time out (NCCL)."""
    import torch.multiprocessing as mp

    from unsupervised_pseuso_lidar_tpu_torch.parallel.distributed import free_port

    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, ranks, port, argv))
             for rank in range(1, ranks)]
    for proc in procs:
        proc.start()
    try:
        trainer = _train_as_rank(args, ranks, device, f"127.0.0.1:{port}", ranks, 0)
        for proc in procs:
            proc.join()
        failed = {rank: p.exitcode for rank, p in enumerate(procs, 1) if p.exitcode}
        if failed:
            raise RuntimeError(f"--mesh {ranks}: ranks failed with exit codes {failed}")
        return trainer
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join()


def _train(args, device, mesh=None):
    """Build the Trainer (under `mesh` when given) and fit; returns it."""
    from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer
    from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger
    from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import trace

    config = load_config(args.config)
    if args.epochs is not None:
        config.action.num_epochs = args.epochs
    if args.batch_size is not None:
        config.action.batch_size = args.batch_size
    profile_ctx = (trace(args.profile, device=device) if args.profile
                   else contextlib.nullcontext())
    # rank 0 alone logs (and starts wandb)
    log_fn = MetricLogger(config) if mesh is None or mesh.rank == 0 else None
    accum = config.action.accum_steps

    if args.synthetic:
        from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import (
            SyntheticTripletDataset,
        )

        height, width = config.image_shape
        dataset = SyntheticTripletDataset(
            num_batches=args.synthetic_batches, batch_size=config.action.batch_size,
            height=height, width=width, uint8_images=True,
        )
        trainer = Trainer(config, dataset=dataset, log_fn=log_fn, device=device,
                          mesh=mesh)
        with profile_ctx:
            trainer.fit(make_train_iter=lambda epoch: prefetch_to_device(
                dataset.batches(epoch), device=trainer.device, mesh=mesh,
                accum_steps=accum))
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
    trainer = Trainer(config, dataset=dataset, log_fn=log_fn, device=device, mesh=mesh)
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
                device=trainer.device, mesh=mesh, accum_steps=accum,
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
