"""Image rows sharded over the mesh's "spatial" axis: halo exchange, row
gather and the band arithmetic the step needs.

The port's own: under JAX's ("data", "spatial") mesh GSPMD partitions
every convolution with halo exchange and places the reductions itself
(parallel/mesh.py :54-63, losses/reprojection.py :47-80, geometry/warp.py
:160-192). Here each rank of a data row holds a band of its images' rows
— the bands of parallel/mesh.row_bands, whose inner edges fall on
multiples of 32 rows — and the code that reads across a band's edge
calls these functions:

  * `halo` brings k rows from the band above and below (a
    torch.autograd.Function: its backward adds the halo rows' gradients
    back into their owner's rows) — the convolutions and the max-pool of
    DispResNet (models/layers.py), SSIM's 3x3 windows (losses/photometric.py),
    the smoothness term's vertical differences (losses/smoothness.py) and
    a coarse scale's bilinear upsample (losses/reprojection.py);
  * `gather_rows` assembles whole images on every rank of a data row
    (data frames, no gradient): the warp's source frames, the pose net's
    input and the evaluation's and the pictures' depth maps
    (train/trainer.py);
  * Mesh.spatial_sum (parallel/mesh.py) sums over the data row with
    autograd: normalize_depth's per-image mean.

A rank's share of a mean over the image is its band's sum over the
image's count (`band_weight`): every loss term is s × that share, so the
mean over the ranks, which the step takes, is the image's mean for
bands of any height.

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

from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import (
    ROW_MULTIPLE,
    Mesh,
    row_bands,
)

# rows a band must hold at every loss scale: the smoothness term's second
# vertical difference reads two rows of the band below
MIN_BAND_ROWS = 2


def row_sharded(mesh: Optional[Mesh]) -> bool:
    """True under a mesh with a "spatial" axis of more than one rank."""
    return mesh is not None and mesh.spatial > 1


def band(mesh: Optional[Mesh], height: int, scale: int = 0) -> slice:
    """This rank's rows of an image `height` rows tall (all of them
    without a spatial axis), or with `scale` its rows of the image's
    scale-`scale` map (ceil(height / 2**scale) rows): the band's edges
    divided by 2**scale, exact at the 32-row grain's inner edges."""
    if not row_sharded(mesh):
        return slice(0, -(-height // 2 ** scale))
    rows = mesh.band(height)
    return slice(rows.start // 2 ** scale, -(-rows.stop // 2 ** scale))


def band_weight(mesh: Optional[Mesh], height: int) -> float:
    """spatial · (this rank's rows) / height: a mean over this rank's band
    of an image `height` rows tall times this is spatial × the band's
    share of the image's mean, so that the mean over the ranks (the
    step's) is the image's mean. 1.0 without a spatial axis and for equal
    bands."""
    if not row_sharded(mesh):
        return 1.0
    rows = mesh.band(height)
    return mesh.spatial * (rows.stop - rows.start) / height


def check_height(mesh: Optional[Mesh], height: int, width: int,
                 scales=(0,)) -> None:
    """Raise ValueError unless DispResNet can shard an image of height x
    width over the mesh's spatial axis with output `scales`: the height a
    multiple of spatial (JAX's rule), every band at least one row of the
    encoder's coarsest level (ceil(height / 32) >= spatial), the last
    band at least MIN_BAND_ROWS rows at every loss scale, and with scales
    beyond 0 the height a multiple of 2**max(scales), so that a coarse
    map's upsample to the image is an integer factor (losses/reprojection
    upsamples it on a band). The same answer on every rank."""
    if not row_sharded(mesh):
        return
    spatial = mesh.spatial
    where = f"a {height}x{width} image does not shard over spatial={spatial}"
    if height % spatial:
        raise ValueError(f"{where}: the height must be a multiple of spatial")
    if -(-height // ROW_MULTIPLE) < spatial:
        raise ValueError(f"{where}: it needs ceil(H/{ROW_MULTIPLE}) >= spatial, one row of "
                         f"the encoder's coarsest level a band (bands of no row are not "
                         f"ported, ROADMAP.md)")
    top = max(scales)
    if height % 2 ** top:
        raise ValueError(f"{where} at scales {tuple(scales)}: the height must be a "
                         f"multiple of {2 ** top}")
    start, stop = row_bands(height, spatial)[-1]
    for scale in scales:
        rows = -(-stop // 2 ** scale) - start // 2 ** scale
        if rows < MIN_BAND_ROWS:
            raise ValueError(f"{where}: its last band holds {rows} row(s) at scale "
                             f"{scale}, fewer than {MIN_BAND_ROWS}")


def first_band(mesh: Mesh) -> bool:
    return mesh.spatial_rank == 0


def last_band(mesh: Mesh) -> bool:
    return mesh.spatial_rank == mesh.spatial - 1


class _Halo(torch.autograd.Function):
    """x [..., R, W] (rows at dim -2) -> [above rows of the band above; x;
    below rows of the band below], each halo absent at the image's border.

    Forward: slot j of a [s, ..., above + below, W] buffer holds band j's
    last `above` rows (none for the last band) and first `below` rows
    (none for the first); one SUM all-reduce; band j reads slot j − 1's
    first part and slot j + 1's second. The bands may differ in height;
    one that holds fewer rows than it must send is refused. Backward: the
    halo rows' gradients go into their owners' slots, one SUM all-reduce,
    and each band adds its slot to the rows it sent."""

    @staticmethod
    def forward(ctx, x, mesh, above, below):
        rows = x.shape[-2]
        j, s = mesh.spatial_rank, mesh.spatial
        send_above = above if j < s - 1 else 0
        send_below = below if j > 0 else 0
        if rows < max(send_above, send_below):
            raise ValueError(f"a band of {rows} rows cannot send "
                             f"{max(send_above, send_below)} halo rows")
        ctx.mesh, ctx.above, ctx.below = mesh, above, below
        buf = x.new_zeros((s, *x.shape[:-2], above + below, x.shape[-1]))
        if send_above:
            buf[j][..., :above, :] = x[..., rows - above:, :]
        if send_below:
            buf[j][..., above:, :] = x[..., :below, :]
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
        if j < s - 1 and above:
            dx[..., rows - above:, :] += buf[j][..., :above, :]
        if j > 0 and below:
            dx[..., :below, :] += buf[j][..., above:, :]
        return dx, None, None, None


def halo(x: torch.Tensor, mesh: Mesh, above: int, below: int) -> torch.Tensor:
    """x [..., R, W], this rank's band (rows at dim -2), with `above` rows
    of the band above prepended and `below` rows of the band below
    appended; at the image's top (bottom) border there is no band above
    (below) and nothing is added there. Differentiable (_Halo)."""
    return _Halo.apply(x.contiguous(), mesh, above, below)


@torch.no_grad()
def image_height(mesh: Mesh, rows: int, device: torch.device) -> int:
    """The image's row count from this rank's band of `rows` rows: the sum
    over the data row (one all-reduce; a host sync)."""
    total = torch.tensor([rows], dtype=torch.int64, device=device)
    dist.all_reduce(total, group=mesh.spatial_group)
    return int(total)


@torch.no_grad()
def gather_rows(x: torch.Tensor, mesh: Mesh, dim: int, height: int) -> torch.Tensor:
    """Every band of the data row along `dim`, in order: this rank's band
    of an image `height` rows tall -> the whole image, the same on every
    rank of the row. No gradient (data frames and evaluation maps). One
    SUM all-reduce of a zeroed buffer that holds this rank's rows at its
    band's offset: a sum of one value and zeros is exact in every
    dtype."""
    dim = dim % x.ndim
    rows = mesh.band(height)
    if x.shape[dim] != rows.stop - rows.start:
        raise ValueError(f"{x.shape[dim]} rows at dim {dim}: band {rows.start}:{rows.stop} "
                         f"of a {height}-row image was expected")
    shape = list(x.shape)
    shape[dim] = height
    out = x.new_zeros(shape)
    out.narrow(dim, rows.start, rows.stop - rows.start).copy_(x)
    dist.all_reduce(out, group=mesh.spatial_group)
    return out
