"""The data mesh and the rules that place a batch and a train state on it.

Counterpart of unsupervised_pseuso_lidar_tpu/parallel/mesh.py (make_mesh
:26, batch_sharding :54, replicated_sharding :66, shard_batch :70,
shard_train_state :94). Under JAX's ("data",) mesh GSPMD runs the
single-device program over the GLOBAL batch; here every rank of a
torch.distributed process group runs the step on its own rows, and the
step makes every reduction over the batch global with a collective: the
BatchNorm statistics, the 'ssim' clip threshold, the supervised term's
masked mean, the metrics, and the parameter gradients once a step
(train/trainer.py). Only `all_reduce` and `broadcast` are used: gloo runs
them on CUDA tensors too (not `all_gather`), so the same code runs under
NCCL, under gloo on the CPU and under gloo on one shared card.

The "spatial" axis (image height sharded, convolutions with halo
exchange) is not ported: make_mesh(spatial > 1) raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device


class Mesh:
    """A ("data",) mesh: the process group (None for the one-device mesh
    without one), this process's rank in it, its size and the device this
    rank computes on. With a group, every collective of the step goes
    through it — at size 1 too, where it changes no value."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over the mesh in place (no autograd) and return it;
        the identity without a group."""
        if self.group is not None:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of `tensor` over the mesh, differentiable: the gradient
        of the sum is the sum of the ranks' gradients, so a rank's
        parameters get the part of every rank's loss that reads its
        values. `tensor` itself without a group."""
        if self.group is None:
            return tensor
        return _AllReduceSum.apply(tensor, self.group)


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is the SUM all-reduce of the
    gradient (torch.distributed.nn.functional.all_reduce's rule, which
    torch deprecates in favour of collectives with no gloo backward)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def make_mesh(
    n_devices: Optional[int] = None,
    spatial: int = 1,
    device: str | torch.device = "cuda",
) -> Mesh:
    """The ("data",) mesh over the default process group, this process
    computing on `device` (a bare "cuda" is the current CUDA device).

    n_devices must be the group's size (None takes it). Without a process
    group only the one-device mesh exists (n_devices None or 1; no
    collective runs then): start N ranks with torchrun or
    `cli.train --mesh N`."""
    if spatial != 1:
        raise NotImplementedError(
            "the 'spatial' mesh axis is not ported: it needs convolutions that "
            "exchange halos between ranks (ROADMAP.md §1, item 5)")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}) needs a process group of {n_devices} ranks "
                "(torchrun, or cli.train --mesh N)")
        return Mesh(None, 0, 1, device)
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh({n_devices}) in a process group of {size} ranks")
    return Mesh(dist.group.WORLD, dist.get_rank(), size, device)


@dataclass(frozen=True)
class Sharding:
    """Where an array lives on the mesh: its `axis` split over "data"
    into contiguous row blocks, one a rank (interleaved by micro-batch
    with accum_steps > 1, see shard_batch), or replicated (axis None)."""

    mesh: Mesh
    axis: Optional[int]
    accum_steps: int = 1

    def rows(self, size: int) -> slice | np.ndarray:
        """This rank's indices along `axis` of an array `size` long."""
        n, k = self.mesh.size, self.accum_steps
        if size % (n * k):
            raise ValueError(f"a batch of {size} rows does not split into {k} "
                             f"micro-batch(es) over {n} devices")
        micro = size // k
        part = micro // n
        start = self.mesh.rank * part
        if k == 1:
            return slice(start, start + part)
        return np.concatenate([np.arange(i * micro + start, i * micro + start + part)
                               for i in range(k)])

    def shard(self, x):
        """This rank's part of the global array `x` (numpy or tensor): a
        view for contiguous rows."""
        if self.axis is None or self.mesh.size == 1:
            return x
        index = [slice(None)] * self.axis + [self.rows(x.shape[self.axis])]
        if isinstance(index[-1], np.ndarray) and torch.is_tensor(x):
            index[-1] = torch.from_numpy(index[-1]).to(x.device)
        return x[tuple(index)]


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> Sharding:
    """The batch dimension over "data" (the mesh has no "spatial" axis)."""
    if not 0 <= batch_axis < ndim:
        raise ValueError(f"batch_axis {batch_axis} of a rank-{ndim} array")
    return Sharding(mesh, batch_axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


class ShardedBatch(dict):
    """A batch dict that already holds this rank's rows (the output of
    shard_batch), so that placing it again is a no-op, as re-placing an
    already sharded array is in JAX."""

    def __init__(self, items, accum_steps: int = 1, batch_axis: int = 0):
        super().__init__(items)
        self.accum_steps = accum_steps
        self.batch_axis = batch_axis

    def with_values(self, items) -> "ShardedBatch":
        return ShardedBatch(items, self.accum_steps, self.batch_axis)


def shard_batch(mesh: Mesh, batch: Any, accum_steps: int = 1, batch_axis: int = 0) -> Any:
    """This rank's rows of a global batch (a dict of numpy arrays or
    tensors, or one array).

    With accum_steps 1, rank r of N takes rows [r·B/N, (r+1)·B/N): the rows
    JAX puts on device r. With accum_steps k > 1 it takes its part of EVERY
    micro-batch — micro-batch i's rows [i·mb + r·mb/N, i·mb + (r+1)·mb/N),
    mb = B/k — since the step splits its rows into k micro-batches and
    micro-batch i's BatchNorm statistics and supervised mean are taken
    over micro-batch i's global rows, as in the JAX step's reshape. B must
    be a multiple of k·N. `groundtruth` [B, H, W] takes the same rows.
    A ShardedBatch is returned as it is."""
    if isinstance(batch, ShardedBatch):
        if (batch.accum_steps, batch.batch_axis) != (accum_steps, batch_axis):
            raise ValueError("the batch was sharded for other micro-batches or axis")
        return batch
    sharding = Sharding(mesh, batch_axis, accum_steps)
    if isinstance(batch, dict):
        return ShardedBatch({k: sharding.shard(v) for k, v in batch.items()},
                            accum_steps, batch_axis)
    return sharding.shard(batch)


def _state_tensors(state) -> list:
    """Every tensor of a TrainState that replication covers, in an order
    that is the same on every rank: parameters and buffers of both nets,
    then each parameter's optimizer slots by name."""
    tensors = []
    for model in (state.depth_model, state.pose_model):
        tensors += [t for _, t in sorted(model.state_dict(keep_vars=True).items())]
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            slots = state.optimizer.state.get(p, {})
            tensors += [slots[k] for k in sorted(slots) if torch.is_tensor(slots[k])]
    return tensors


def shard_train_state(mesh: Mesh, state: Any) -> Any:
    """Replicate the train state over the mesh: broadcast rank 0's
    parameters, buffers, optimizer slots and step count to every rank (in
    place; returns the state). Every rank must hold the same structure,
    as ranks that built the state from one config and restored the same
    checkpoint do."""
    if not mesh.distributed:
        return state
    src = dist.get_global_rank(mesh.group, 0)
    step = torch.tensor([state.step], dtype=torch.int64, device=mesh.device)
    dist.broadcast(step, src=src, group=mesh.group)
    if int(step) != state.step:
        raise ValueError(f"rank {mesh.rank} is at step {state.step}, rank 0 at "
                         f"{int(step)}: the ranks restored different checkpoints")
    with torch.no_grad():
        for t in _state_tensors(state):
            # Adam's step slot is a host scalar; NCCL moves device memory only
            buf = t.data if t.device == mesh.device else t.data.to(mesh.device)
            dist.broadcast(buf, src=src, group=mesh.group)
            if buf is not t.data:
                t.data.copy_(buf)
    return state
