"""Image rows sharded over the mesh's "spatial" axis: halo exchange, row
gather and the band arithmetic the step needs.

The port's own: under JAX's ("data", "spatial") mesh GSPMD partitions
every convolution with halo exchange and places the reductions itself
(parallel/mesh.py :54-63, losses/reprojection.py :47-80, geometry/warp.py
:160-192). Here each rank of a data row holds a band of its images' rows
— the bands of parallel/mesh.row_bands, whose inner edges fall on
multiples of 32 rows, or JAX's equal bands where there are fewer rows of
32 than bands — and the code that reads across a band's edge calls these
functions:

  * `halo` brings k rows from the bands above and below, past a band
    shorter than k (a torch.autograd.Function: its backward adds the
    halo rows' gradients back into their owners' rows) — the
    convolutions, transposed convolutions and max-pools of the depth nets
    (models/layers.py), SSIM's 3x3 windows (losses/photometric.py), the
    smoothness term's vertical differences (losses/smoothness.py) and a
    coarse scale's bilinear upsample (losses/reprojection.py,
    models/depth/dispnet.py);
  * `gather_band` assembles a whole map from the bands, with its
    gradient, where a net's level is not banded (`banded_level`: a
    band's first row is not a multiple of 2**level), and `cut_band` cuts
    the band back out at the first finer level that is; the layers apply
    the rule themselves (`on_bands`, `whole`, `placed`) at the level they
    are given, for the image height the net's forward is given. A coarse
    map whose resize to the image is no integer factor is gathered,
    resized whole and cut back the same way (losses/reprojection.py,
    StnDispNet's output). Which of a net's outputs are bands and which
    whole maps its net declares (layers.Banded.banded_outputs, by default
    `banded_outputs`), and the loss takes that declaration
    (`check_placement` holds each map to it);
  * `gather_rows` assembles whole images on every rank of a data row
    (data frames, no gradient): the warp's source frames, the pose net's
    input and the evaluation's and the pictures' depth maps
    (train/trainer.py);
  * Mesh.spatial_sum (parallel/mesh.py) sums over the data row with
    autograd: normalize_depth's per-image mean and GroupNorm's
    per-image statistics (models/layers.py).

A rank's share of a mean over the image is its band's sum over the
image's count (`band_weight`): every loss term is s × that share, so the
mean over the ranks, which the step takes, is the image's mean for
bands of any height.

Every exchange is one SUM all-reduce over the data row's group: each
rank writes what it sends into its own slot of a zeroed buffer. gloo runs
only all_reduce and broadcast on CUDA tensors, so this is one code path
for NCCL, for gloo on the CPU and for gloo on one shared card (a
point-to-point exchange under NCCL is later work, ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh, row_bands


def row_sharded(mesh: Optional[Mesh]) -> bool:
    """True under a mesh with a "spatial" axis of more than one rank."""
    return mesh is not None and mesh.spatial > 1


def band(mesh: Optional[Mesh], height: int, scale: int = 0) -> slice:
    """This rank's rows of an image `height` rows tall (all of them
    without a spatial axis), or with `scale` its rows of the image's
    scale-`scale` map (ceil(height / 2**scale) rows): the band's edges
    divided by 2**scale, exact where the level is banded
    (banded_level)."""
    if not row_sharded(mesh):
        return slice(0, -(-height // 2 ** scale))
    rows = mesh.band(height)
    return slice(rows.start // 2 ** scale, -(-rows.stop // 2 ** scale))


def banded_level(mesh: Optional[Mesh], height: int, level: int) -> bool:
    """The banded-level rule: under a spatial mesh, the maps of `level`
    (2**level times fewer rows than an image `height` rows tall) are
    bands iff every band's first row is a multiple of 2**level — then a
    band's rows at that level are whole rows, and a stride-2 window over
    the band yields exactly the image's output rows of it. Otherwise the
    level's maps are computed whole on every rank of the data row, from
    a gathered map (gather_band), and cut back to the band (cut_band) at
    the first finer level that is banded again. The 32-row grain of
    parallel/mesh.row_bands keeps levels 0-5 banded; JAX's equal bands,
    placed where ceil(H/32) < spatial, are banded down to the largest
    power of two that divides the band's height. Level 0 is always
    banded. False without a spatial axis."""
    if not row_sharded(mesh):
        return False
    return all(start % 2 ** level == 0 for start, _ in row_bands(height, mesh.spatial))


def level_rows(mesh: Mesh, height: int, level: int) -> Tuple[int, ...]:
    """Every band's row count at a banded `level`, top to bottom (the
    halo's reach past a short band)."""
    return tuple(-(-stop // 2 ** level) - start // 2 ** level
                 for start, stop in row_bands(height, mesh.spatial))


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
                 multiple: int = 1) -> None:
    """Raise ValueError unless a depth net can shard an image of height x
    width over the mesh's spatial axis: the height a multiple of spatial
    (JAX's rule) and of the net's own `multiple` (BtsModel's 32, below
    which JAX's model cannot concatenate its skips either). Bands of any
    height are taken otherwise: a level whose bands hold no whole row is
    computed on the gathered map (banded_level), and a coarse map whose
    upsample to the image is no integer factor is resized whole (the
    loss's _full_res_depth, StnDispNet's 16·ceil(H/16) rows). The same
    answer on every rank."""
    if not row_sharded(mesh):
        return
    spatial = mesh.spatial
    where = f"a {height}x{width} image does not shard over spatial={spatial}"
    if height % spatial:
        raise ValueError(f"{where}: the height must be a multiple of spatial")
    if height % multiple:
        raise ValueError(f"{where}: the depth net needs a height that is a multiple of "
                         f"{multiple}")


def on_bands(mesh: Optional[Mesh], height: Optional[int], level: Optional[int]) -> bool:
    """Whether a layer at `level` of a depth net computes on bands of an
    image `height` rows tall: under a spatial axis, iff the level is
    banded (banded_level). False without a spatial axis. Under one, a
    layer whose level or image height is not set raises ValueError."""
    if not row_sharded(mesh):
        return False
    if level is None or height is None:
        raise ValueError(f"a layer under a spatial mesh needs its level ({level}) and the "
                         f"image's height ({height}): the depth net's forward takes the "
                         "height")
    return banded_level(mesh, height, level)


def whole(x: torch.Tensor, mesh: Optional[Mesh], height: Optional[int],
          level: Optional[int]) -> torch.Tensor:
    """x, a map at `level` of an image `height` rows tall in that level's
    placement -> the whole map: gathered with its gradient (gather_band)
    where the level is banded, x itself where it is already whole."""
    if not on_bands(mesh, height, level):
        return x
    return gather_band(x, mesh, height, level)


def placed(x: torch.Tensor, mesh: Optional[Mesh], height: Optional[int],
           level: Optional[int]) -> torch.Tensor:
    """x, a level-`level` map made by a x2 upsample (a transposed conv, a
    nearest or bilinear resize) of a level + 1 map in that level's
    placement -> x in `level`'s placement: this rank's band cut out of
    the whole map where level + 1 is whole and `level` banded (cut_band),
    x itself otherwise."""
    if not on_bands(mesh, height, level) or on_bands(mesh, height, level + 1):
        return x
    return cut_band(x, mesh, height, level)


def banded_outputs(mesh: Optional[Mesh], height: int,
                   scales: Sequence[int]) -> Tuple[bool, ...]:
    """The default placement of a depth net's outputs of `scales` for an
    image `height` rows tall: output i is this rank's band of its map's
    rows (band(mesh, height, scales[i])) iff its level is banded
    (banded_level), else the whole map, every rank's copy; all whole
    without a spatial axis. What layers.Banded.banded_outputs declares
    unless a net overrides it, and what the losses take where they are
    not told."""
    return tuple(banded_level(mesh, height, scale) for scale in scales)


def check_placement(x: torch.Tensor, mesh: Mesh, height: int, level: int,
                    banded: bool) -> None:
    """Raise ValueError where x [B, C, R, W], a depth net's level-`level`
    output for an image `height` rows tall under a spatial mesh, does not
    hold the rows its net declares: this rank's band's
    (band(mesh, height, level)) where `banded`, at least the whole map's
    (ceil(height / 2**level); StnDispNet's 16·ceil(H/16)) where whole. A
    band of a banded level holds fewer rows than the whole map."""
    count = x.shape[2]
    rows = band(mesh, height, level)
    whole = -(-height // 2 ** level)
    if (count == rows.stop - rows.start) if banded else (count >= whole):
        return
    raise ValueError(f"a level-{level} map of {count} rows under the spatial mesh, "
                     f"declared {'a band' if banded else 'whole'}: this rank's band of it "
                     f"is rows {rows.start}:{rows.stop} of a {whole}-row map")


def first_band(mesh: Mesh) -> bool:
    return mesh.spatial_rank == 0


def last_band(mesh: Mesh) -> bool:
    return mesh.spatial_rank == mesh.spatial - 1


class _Halo(torch.autograd.Function):
    """x [..., R, W] (rows at dim -2) -> [the `above` image rows above the
    band; x; the `below` rows below it], fewer where the image ends.

    Forward: slot j of a [s, ..., above + below, W] buffer holds band j's
    last min(above, R_j) rows (right-aligned) and first min(below, R_j)
    rows; one SUM all-reduce; band j reads the rows above it from slots
    j − 1, j − 2, … and the rows below it from slots j + 1, j + 2, …, as
    many of each band as it holds (`rows`, every band's row count), until
    it has what it asked for or the image ends: a halo reaches past a
    band shorter than itself. Backward: each halo row's gradient goes
    into its owner's slot at the row's place, one SUM all-reduce, and
    each band adds its slot to the rows it sent."""

    @staticmethod
    def forward(ctx, x, mesh, above, below, rows):
        count = x.shape[-2]
        j, s = mesh.spatial_rank, mesh.spatial
        reads_above = _reads(rows, j, above, -1)
        reads_below = _reads(rows, j, below, 1)
        ctx.mesh, ctx.above, ctx.below = mesh, above, below
        ctx.reads = reads_above, reads_below
        buf = x.new_zeros((s, *x.shape[:-2], above + below, x.shape[-1]))
        tail, head = min(above, count), min(below, count)
        if tail:
            buf[j][..., above - tail:above, :] = x[..., count - tail:, :]
        if head:
            buf[j][..., above:above + head, :] = x[..., :head, :]
        dist.all_reduce(buf, group=mesh.spatial_group)
        parts = [buf[i][..., above - n:above, :] for i, n in reversed(reads_above)]
        parts.append(x)
        parts += [buf[i][..., above:above + n, :] for i, n in reads_below]
        return torch.cat(parts, dim=-2)

    @staticmethod
    def backward(ctx, grad):
        mesh, above, below = ctx.mesh, ctx.above, ctx.below
        reads_above, reads_below = ctx.reads
        j, s = mesh.spatial_rank, mesh.spatial
        top = sum(n for _, n in reads_above)
        count = grad.shape[-2] - top - sum(n for _, n in reads_below)
        buf = grad.new_zeros((s, *grad.shape[:-2], above + below, grad.shape[-1]))
        offset = top
        for i, n in reads_above:  # nearest band first: the rows just above x
            buf[i][..., above - n:above, :] = grad[..., offset - n:offset, :]
            offset -= n
        offset = top + count
        for i, n in reads_below:
            buf[i][..., above:above + n, :] = grad[..., offset:offset + n, :]
            offset += n
        dist.all_reduce(buf, group=mesh.spatial_group)
        dx = grad[..., top:top + count, :].clone()
        tail, head = min(above, count), min(below, count)
        if j < s - 1 and tail:
            dx[..., count - tail:, :] += buf[j][..., above - tail:above, :]
        if j > 0 and head:
            dx[..., :head, :] += buf[j][..., above:above + head, :]
        return dx, None, None, None, None


def _reads(rows, j, want, step):
    """[(band i, rows taken from it)] of band j's halo of `want` rows in
    direction `step` (−1 up, +1 down), nearest band first: as many rows
    of each band as it holds, until `want` or the image's border."""
    reads = []
    i = j + step
    while want > 0 and 0 <= i < len(rows):
        n = min(rows[i], want)
        if n:
            reads.append((i, n))
        want -= n
        i += step
    return reads


def halo(x: torch.Tensor, mesh: Mesh, above: int, below: int,
         rows: Sequence[int]) -> torch.Tensor:
    """x [..., R, W], this rank's band (rows at dim -2), with the `above`
    image rows above it prepended and the `below` rows below it appended,
    taken from as many bands as hold them (`rows`: every band's row
    count at x's level, level_rows); at the image's top (bottom) border
    fewer rows, or none, are added (halo_reach says how many).
    Differentiable (_Halo)."""
    if not above and not below:
        return x
    return _Halo.apply(x.contiguous(), mesh, above, below, tuple(rows))


def halo_reach(mesh: Mesh, above: int, below: int, rows: Sequence[int]) -> Tuple[int, int]:
    """(rows added above, rows added below) by halo(x, mesh, above, below,
    rows) on this rank: all of them but where the image ends."""
    j = mesh.spatial_rank
    return min(above, sum(rows[:j])), min(below, sum(rows[j + 1:]))


@torch.no_grad()
def gather_rows(x: torch.Tensor, mesh: Mesh, dim: int, height: int) -> torch.Tensor:
    """Every band of the data row along `dim`, in order: this rank's band
    of an image `height` rows tall -> the whole image, the same on every
    rank of the row. No gradient (data frames and evaluation maps):
    gather_band's forward, one SUM all-reduce of a zeroed buffer that
    holds this rank's rows at its band's offset — a sum of one value and
    zeros is exact in every dtype."""
    return gather_band(x, mesh, height, 0, dim)


class _GatherBand(torch.autograd.Function):
    """gather_band's function: forward a zeroed whole map holding this
    rank's rows at its band's offset, one SUM all-reduce; backward the SUM
    all-reduce of the whole map's cotangent
    over the data row, of which this band's rows are returned. Every rank
    of the row computes on its own copy of the whole map and feeds its
    own loss from it, so the copies' cotangents add (reduce-scatter
    semantics)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, rows, total):
        ctx.mesh, ctx.dim, ctx.rows = mesh, dim, rows
        shape = list(x.shape)
        shape[dim] = total
        out = x.new_zeros(shape)
        out.narrow(dim, rows.start, rows.stop - rows.start).copy_(x)
        dist.all_reduce(out, group=mesh.spatial_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.spatial_group)
        rows = ctx.rows
        return (grad.narrow(ctx.dim, rows.start, rows.stop - rows.start).contiguous(),
                None, None, None, None)


def gather_band(x: torch.Tensor, mesh: Mesh, height: int, level: int = 0,
                dim: int = 2, total: Optional[int] = None) -> torch.Tensor:
    """This rank's band of a level-`level` map of an image `height` rows
    tall (band(mesh, height, level), a banded level) -> the whole map
    (ceil(height / 2**level) rows along `dim`, or `total` rows where the
    net's map runs past the image's last row, its last band to the map's
    end as cut_band leaves it), the same on every rank of the data row;
    differentiable (_GatherBand)."""
    dim = dim % x.ndim
    rows = band(mesh, height, level)
    total = -(-height // 2 ** level) if total is None else total
    if last_band(mesh):
        rows = slice(rows.start, total)
    if x.shape[dim] != rows.stop - rows.start:
        raise ValueError(f"{x.shape[dim]} rows at dim {dim}: band {rows.start}:{rows.stop} of "
                         f"the level-{level} map of a {height}-row image was expected")
    return _GatherBand.apply(x, mesh, dim, rows, total)


def cut_band(x: torch.Tensor, mesh: Mesh, height: int, level: int = 0,
             dim: int = 2) -> torch.Tensor:
    """gather_band's inverse: a whole level-`level` map -> this rank's band
    of its rows along `dim`, the last band to the map's end (a transposed
    conv's map may run past the image's last row, as on the whole map).
    Differentiable (a slice: the other rows get no cotangent here, and
    the gather that made the map adds the ranks' cotangents)."""
    rows = band(mesh, height, level)
    stop = x.shape[dim] if last_band(mesh) else rows.stop
    return x.narrow(dim, rows.start, stop - rows.start)
