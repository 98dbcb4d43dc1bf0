"""Image rows sharded over the mesh's "spatial" axis: halo exchange, row
gather and the band arithmetic the step needs.

The port's own: under JAX's ("data", "spatial") mesh GSPMD partitions
every convolution with halo exchange and places the reductions itself
(parallel/mesh.py :54-63, losses/reprojection.py :47-80, geometry/warp.py
:160-192). Here each rank of a data row holds a band of its images' rows
— rank at spatial index j of s holds rows [j·H/s, (j+1)·H/s) — and the
code that reads across a band's edge calls these functions:

  * `halo` brings k rows from the band above and below (a
    torch.autograd.Function: its backward adds the halo rows' gradients
    back into their owner's rows) — the convolutions and the max-pool of
    DispResNet (models/layers.py), SSIM's 3x3 windows (losses/photometric.py)
    and the smoothness term's vertical differences (losses/smoothness.py);
  * `gather_rows` assembles whole images on every rank of a data row
    (data frames, no gradient): the warp's source frames, the pose net's
    input and the evaluation's depth maps (train/trainer.py);
  * Mesh.spatial_sum (parallel/mesh.py) sums over the data row with
    autograd: normalize_depth's per-image mean.

Both exchanges are one SUM all-reduce over the data row's group: each
rank writes what it sends into its own slot of a zeroed buffer. gloo runs
only all_reduce and broadcast on CUDA tensors, so this is one code path
for NCCL, for gloo on the CPU and for gloo on one shared card (a
point-to-point exchange under NCCL is later work, ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh

# DispResNet's encoder halves the rows five times: a band of H/s rows
# keeps an even row count and an even first row at every level when
# H is a multiple of 32·s, which makes each band's stride-2 outputs
# exactly the global output rows of that band
ROW_MULTIPLE = 32


def row_sharded(mesh: Optional[Mesh]) -> bool:
    """True under a mesh with a "spatial" axis of more than one rank."""
    return mesh is not None and mesh.spatial > 1


def band(mesh: Optional[Mesh], height: int) -> slice:
    """This rank's rows of an image `height` rows tall (all of them
    without a spatial axis)."""
    return mesh.band(height) if row_sharded(mesh) else slice(0, height)


def check_height(mesh: Optional[Mesh], height: int, width: int) -> None:
    """Raise ValueError unless DispResNet can shard an image of height x
    width over the mesh's spatial axis (H a multiple of 32·spatial; JAX
    pads uneven shards, the port does not)."""
    if row_sharded(mesh) and height % (ROW_MULTIPLE * mesh.spatial):
        raise ValueError(
            f"a {height}x{width} image does not shard over spatial={mesh.spatial}: "
            f"the height must be a multiple of {ROW_MULTIPLE * mesh.spatial}")


def first_band(mesh: Mesh) -> bool:
    return mesh.spatial_rank == 0


def last_band(mesh: Mesh) -> bool:
    return mesh.spatial_rank == mesh.spatial - 1


class _Halo(torch.autograd.Function):
    """x [..., R, W] (rows at dim -2) -> [above rows of the band above; x;
    below rows of the band below], each halo absent at the image's border.

    Forward: slot j of a [s, ..., above + below, W] buffer holds band j's
    last `above` rows and first `below` rows; one SUM all-reduce; band j
    reads slot j − 1's first part and slot j + 1's second. Backward: the
    halo rows' gradients go into their owners' slots, one SUM all-reduce,
    and each band adds its slot to the rows it sent."""

    @staticmethod
    def forward(ctx, x, mesh, above, below):
        rows = x.shape[-2]
        if rows < max(above, below):
            raise ValueError(f"a band of {rows} rows cannot send {max(above, below)} halo rows")
        j, s = mesh.spatial_rank, mesh.spatial
        ctx.mesh, ctx.above, ctx.below = mesh, above, below
        buf = x.new_zeros((s, *x.shape[:-2], above + below, x.shape[-1]))
        buf[j] = torch.cat([x[..., rows - above:, :], x[..., :below, :]], dim=-2)
        dist.all_reduce(buf, group=mesh.spatial_group)
        parts = []
        if j > 0:
            parts.append(buf[j - 1][..., :above, :])
        parts.append(x)
        if j < s - 1:
            parts.append(buf[j + 1][..., above:, :])
        return torch.cat(parts, dim=-2)

    @staticmethod
    def backward(ctx, grad):
        mesh, above, below = ctx.mesh, ctx.above, ctx.below
        j, s = mesh.spatial_rank, mesh.spatial
        top = above if j > 0 else 0
        rows = grad.shape[-2] - top - (below if j < s - 1 else 0)
        buf = grad.new_zeros((s, *grad.shape[:-2], above + below, grad.shape[-1]))
        if j > 0:
            buf[j - 1][..., :above, :] = grad[..., :above, :]
        if j < s - 1:
            buf[j + 1][..., above:, :] = grad[..., top + rows:, :]
        dist.all_reduce(buf, group=mesh.spatial_group)
        dx = grad[..., top:top + rows, :].clone()
        dx[..., rows - above:, :] += buf[j][..., :above, :]
        dx[..., :below, :] += buf[j][..., above:, :]
        return dx, None, None, None


def halo(x: torch.Tensor, mesh: Mesh, above: int, below: int) -> torch.Tensor:
    """x [..., R, W], this rank's band (rows at dim -2), with `above` rows
    of the band above prepended and `below` rows of the band below
    appended; at the image's top (bottom) border there is no band above
    (below) and nothing is added there. Differentiable (_Halo)."""
    return _Halo.apply(x.contiguous(), mesh, above, below)


@torch.no_grad()
def gather_rows(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every band of the data row along `dim`, in order: this rank's band
    of an image -> the whole image, the same on every rank of the row. No
    gradient (data frames and evaluation maps). One SUM all-reduce of a
    zeroed buffer that holds this rank's rows in its place: a sum of one
    value and zeros is exact in every dtype."""
    dim = dim % x.ndim
    rows = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = rows * mesh.spatial
    out = x.new_zeros(shape)
    out.narrow(dim, mesh.spatial_rank * rows, rows).copy_(x)
    dist.all_reduce(out, group=mesh.spatial_group)
    return out
