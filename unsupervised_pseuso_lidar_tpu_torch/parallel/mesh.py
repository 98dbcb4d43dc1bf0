"""The ("data", "spatial") mesh and the rules that place a batch and a
train state on it.

Counterpart of unsupervised_pseuso_lidar_tpu/parallel/mesh.py (make_mesh
:26, batch_sharding :54, replicated_sharding :66, shard_batch :70,
shard_train_state :94). Under JAX's mesh GSPMD runs the single-device
program over the GLOBAL batch; here every rank of a torch.distributed
process group runs the step on its own block of the batch — its images
(the "data" axis) and, with a "spatial" axis, its band of image rows —
and the step makes every reduction global with a collective: the
BatchNorm statistics, the 'ssim' clip threshold, the supervised term's
masked mean, the metrics, and the parameter gradients once a step
(train/trainer.py). Under a spatial axis the convolutions exchange halo
rows with the neighbouring row bands, and the loss takes its windows and
its per-image sums across the bands (parallel/spatial.py). Only
`all_reduce` and `broadcast` are used: gloo runs them on CUDA tensors too
(not `all_gather`), so the same code runs under NCCL, under gloo on the
CPU and under gloo on one shared card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device


# the grain of the row bands: DispResNet's encoder halves the rows five
# times, so a band edge at a multiple of 32 image rows is an integer row
# at every level and every loss scale, and a stride-2 window over a band
# that starts there yields exactly the image's output rows of that band
ROW_MULTIPLE = 32


def row_bands(height: int, spatial: int) -> list:
    """[(start, stop)] of the `spatial` bands of an image `height` rows
    tall, top to bottom. The C = ceil(height / 32) rows of 32 are split as
    evenly as possible, the larger parts first, and band j holds image
    rows [32·c_j, min(32·c_{j+1}, height)): 192 rows over 4 are 64, 64,
    32, 32; where height is a multiple of 32·spatial these are the equal
    bands JAX places. Only the last band can hold a row count that is not
    a multiple of 32. With fewer rows of 32 than bands (a band would hold
    none) the bands are equal, as JAX places them: the depth nets then
    compute the levels whose bands hold no whole row on the gathered map
    (parallel/spatial.banded_level). Raises ValueError unless spatial divides height (JAX's
    rule for a sharded dimension)."""
    if height % spatial:
        raise ValueError(f"an image of {height} rows does not split into {spatial} bands "
                         f"(the spatial mesh needs the height a multiple of spatial)")
    coarse = -(-height // ROW_MULTIPLE)
    if coarse < spatial:
        part = height // spatial
        return [(j * part, (j + 1) * part) for j in range(spatial)]
    base, extra = divmod(coarse, spatial)
    edges = [0]
    for j in range(spatial):
        edges.append(edges[-1] + base + (j < extra))
    return [(ROW_MULTIPLE * edges[j], min(ROW_MULTIPLE * edges[j + 1], height))
            for j in range(spatial)]


class Mesh:
    """A ("data",) or ("data", "spatial") mesh: the process group (None for
    the one-device mesh without one), this process's rank in it, its size,
    the device this rank computes on, and the size of the "spatial" axis.
    With a group, every collective of the step goes through it — at size 1
    too, where it changes no value.

    JAX's layout (make_mesh's devices.reshape(n // spatial, spatial)): rank
    r sits at data index r // spatial and spatial index r % spatial, so a
    data row — the ranks that hold one block of images, each a band of
    their rows — is `spatial` consecutive ranks. `spatial_group` is this
    rank's data row (None without a spatial axis)."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 spatial: int = 1, spatial_group=None):
        if size % spatial:
            raise ValueError(f"{size} devices not divisible by spatial={spatial}")
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.spatial = spatial
        self.spatial_group = spatial_group

    @property
    def shape(self) -> Dict[str, int]:
        if self.spatial == 1:
            return {"data": self.size}
        return {"data": self.size // self.spatial, "spatial": self.spatial}

    @property
    def data_size(self) -> int:
        return self.size // self.spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.spatial

    def band(self, height: int) -> slice:
        """This rank's band of the rows of an image `height` rows tall
        (row_bands)."""
        return slice(*row_bands(height, self.spatial)[self.spatial_rank])

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: an NCCL
        group on a CUDA device, whose collectives are kernels on the
        card. gloo runs its collectives on the host, so a gloo mesh is
        never captured; a mesh without a group runs no collective (the
        no-mesh case)."""
        return (self.group is not None and self.device.type == "cuda"
                and dist.get_backend(self.group) == "nccl")

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

    def spatial_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """all_reduce_sum over this rank's data row only (the bands of one
        block of images); `tensor` itself without a spatial axis."""
        if self.spatial_group is None:
            return tensor
        return _AllReduceSum.apply(tensor, self.spatial_group)


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
    """The ("data",) mesh, or with spatial > 1 the ("data", "spatial") mesh
    of n_devices // spatial data rows, over the default process group,
    this process computing on `device` (a bare "cuda" is the current CUDA
    device).

    n_devices must be the group's size (None takes it), a multiple of
    `spatial`. Without a process group only the one-device mesh exists
    (n_devices None or 1, spatial 1; no collective runs then): start N
    ranks with torchrun or `cli.train --mesh N`. With a spatial axis
    every rank creates the subgroup of every data row, in the same order
    (dist.new_group's rule), and keeps its own."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1) or spatial != 1:
            n = n_devices if n_devices is not None else spatial
            raise ValueError(
                f"make_mesh({n_devices}, spatial={spatial}) needs a process group of "
                f"{n} ranks (torchrun, or cli.train --mesh N)")
        return Mesh(None, 0, 1, device)
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh({n_devices}) in a process group of {size} ranks")
    if size % spatial:
        raise ValueError(f"{size} devices not divisible by spatial={spatial}")
    rank = dist.get_rank()
    spatial_group = None
    if spatial > 1:
        for row in range(size // spatial):
            group = dist.new_group(list(range(row * spatial, (row + 1) * spatial)))
            if row == rank // spatial:
                spatial_group = group
    return Mesh(dist.group.WORLD, rank, size, device, spatial, spatial_group)


@dataclass(frozen=True)
class Sharding:
    """Where an array lives on the mesh: its `axis` split over "data"
    into contiguous row blocks, one a data row of the mesh (interleaved by
    micro-batch with accum_steps > 1, see shard_batch), and its
    `spatial_axis` (image rows) split over "spatial" into the bands of
    row_bands; or replicated (both None)."""

    mesh: Mesh
    axis: Optional[int]
    accum_steps: int = 1
    spatial_axis: Optional[int] = None

    def rows(self, size: int) -> slice | np.ndarray:
        """This rank's indices along `axis` of an array `size` long."""
        n, k = self.mesh.data_size, self.accum_steps
        if size % (n * k):
            raise ValueError(f"a batch of {size} rows does not split into {k} "
                             f"micro-batch(es) over {n} devices")
        micro = size // k
        part = micro // n
        start = self.mesh.data_rank * part
        if k == 1:
            return slice(start, start + part)
        return np.concatenate([np.arange(i * micro + start, i * micro + start + part)
                               for i in range(k)])

    def shard(self, x):
        """This rank's part of the global array `x` (numpy or tensor): a
        view for contiguous rows."""
        index = [slice(None)] * x.ndim
        if self.axis is not None and self.mesh.data_size > 1:
            index[self.axis] = self.rows(x.shape[self.axis])
            if isinstance(index[self.axis], np.ndarray) and torch.is_tensor(x):
                index[self.axis] = torch.from_numpy(index[self.axis]).to(x.device)
        if self.spatial_axis is not None and self.mesh.spatial > 1:
            index[self.spatial_axis] = self.mesh.band(x.shape[self.spatial_axis])
        return x[tuple(index)]


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> Sharding:
    """The batch dimension over "data" and, when the mesh has a "spatial"
    axis, the image rows over it: channels-last images have their rows
    third from last — [B, H, W, C] and the stacked [B, 2, H, W, C] ref
    pair alike — so an array of at least 4 dimensions after batch_axis
    has axis ndim − 3 split (JAX's rule, with batch_axis 0)."""
    if not 0 <= batch_axis < ndim:
        raise ValueError(f"batch_axis {batch_axis} of a rank-{ndim} array")
    spatial_axis = ndim - 3 if mesh.spatial > 1 and ndim - batch_axis >= 4 else None
    return Sharding(mesh, batch_axis, spatial_axis=spatial_axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


class ShardedBatch(dict):
    """A batch dict that already holds this rank's rows (the output of
    shard_batch), so that placing it again is a no-op, as re-placing an
    already sharded array is in JAX. `height` is the global batch's
    image height (its tgt's rows before sharding; None without a tgt):
    under a "spatial" axis a rank holds a band of the rows, and the host
    knows the whole image's height from here, not from the device."""

    def __init__(self, items, accum_steps: int = 1, batch_axis: int = 0,
                 height: Optional[int] = None):
        super().__init__(items)
        self.accum_steps = accum_steps
        self.batch_axis = batch_axis
        self.height = height

    def with_values(self, items) -> "ShardedBatch":
        return ShardedBatch(items, self.accum_steps, self.batch_axis, self.height)


def shard_batch(mesh: Mesh, batch: Any, accum_steps: int = 1, batch_axis: int = 0) -> Any:
    """This rank's rows of a global batch (a dict of numpy arrays or
    tensors, or one array).

    With accum_steps 1, rank r of N takes rows [r·B/N, (r+1)·B/N): the rows
    JAX puts on device r. With accum_steps k > 1 it takes its part of EVERY
    micro-batch — micro-batch i's rows [i·mb + r·mb/N, i·mb + (r+1)·mb/N),
    mb = B/k — since the step splits its rows into k micro-batches and
    micro-batch i's BatchNorm statistics and supervised mean are taken
    over micro-batch i's global rows, as in the JAX step's reshape. B must
    be a multiple of k·N. Here N is the mesh's data size: the ranks of one
    data row hold the same images. With a "spatial" axis each of them
    takes its band of the image rows (batch_sharding), and `groundtruth`
    [B, H, W] its band along H (JAX :77-86). A ShardedBatch is returned as
    it is. A dict comes back as a ShardedBatch that records the global
    image height."""
    if isinstance(batch, ShardedBatch):
        if (batch.accum_steps, batch.batch_axis) != (accum_steps, batch_axis):
            raise ValueError("the batch was sharded for other micro-batches or axis")
        return batch

    def shard(key, x):
        spatial_axis = batch_sharding(mesh, x.ndim, batch_axis).spatial_axis
        if key == "groundtruth" and x.ndim == batch_axis + 3 and mesh.spatial > 1:
            spatial_axis = batch_axis + 1  # [B, H, W]: the rows follow B
        return Sharding(mesh, batch_axis, accum_steps, spatial_axis).shard(x)

    if isinstance(batch, dict):
        height = batch["tgt"].shape[batch_axis + 1] if "tgt" in batch else None
        return ShardedBatch({k: shard(k, v) for k, v in batch.items()},
                            accum_steps, batch_axis, height)
    return shard(None, batch)


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
    """Replicate the train state over the whole mesh (every data row and
    every band of it): broadcast rank 0's
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
