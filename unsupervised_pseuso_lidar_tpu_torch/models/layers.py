"""Shared conv building blocks (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/models/layers.py, ported for
its semantics only: Conv3x3 = reflection pad 1 + 3x3 conv, ConvBlock =
Conv3x3 + ELU, strided convs with torch's symmetric (k-1)//2 padding
(nn.Conv2d's own), TorchConvTranspose (:159), DownsampleConvBN (:560),
DownsampleConvGN (:586) and UpconvGN (:605), and the BatchNorm with
flax's running-statistics rule. The TPU layout rewrites there
(space-to-depth stem, pre_upsample2x phase convs, s2d_tail / s2d_domain,
border-ring convs) compute the same function with the same parameters and
have no counterpart here.

Every strided conv (Conv2d, and the pose nets' StridedConv2d) runs
through conv2d, which pads a one-column map explicitly where the conv runs
in bf16 on the CPU (oneDNN's weight gradient of that case is faulty).

The blocks are nn.Sequential in the reference's layout, so their
state-dict keys are the reference's (conv1.0 / conv1.2 / conv1.3 for a
DispNetS encoder block, upconv_1.0 / upconv_1.1 for a StnDispNet one).

Row sharding (a mesh with a "spatial" axis, parallel/spatial.py): Conv2d
(dilated too), MaxPool2d, AvgPool2d, Conv3x3, ConvTranspose2d and
GroupNorm are nn.Conv2d, nn.MaxPool2d, nn.AvgPool2d, the reflect-padded
conv, nn.ConvTranspose2d and nn.GroupNorm that, once `mesh` is set on
them (trainer.bind_spatial), run on a band of the image's rows: the
windows take the rows they read across the band's edges from the
neighbouring bands (halo exchange) and pad only at the image's top and
bottom — zeros for a conv, −inf for the max-pool, the reflection for
Conv3x3, a zero row under the transposed conv; the 2x2 average pool
reads none — and GroupNorm takes each image's statistics over the data
row.
Each knows its `level` (its input is 2**level times smaller than the
image; set by its net) and the image's `height` (set by its net's
forward, set_image_height) and applies the banded-level rule there
(spatial.on_bands): at a level whose bands hold no whole row it runs as
its parent on the whole map, gathered from the bands (spatial.whole),
and a transposed conv whose output level is banded again cuts its band
out (spatial.placed). Without a mesh they are their parents. The module
names, and so the state dicts, are unchanged.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import reflect_pad1
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import (
    first_band,
    halo,
    halo_reach,
    last_band,
    level_rows,
    on_bands,
    placed,
    row_sharded,
    whole,
)


# flax GroupNorm's default epsilon (nn.GroupNorm's is 1e-5)
GN_EPS = 1e-6


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's running-statistics update in train mode.

    flax BatchNorm normalizes a training batch as torch does, but moves
    running_var toward the BIASED batch variance E[x²] − E[x]² (fp32,
    clipped at 0), where torch uses the unbiased one (a factor n/(n−1): 4 %
    at 24 values per channel). Here the running statistics are updated the
    flax way — (1 − momentum) · running + momentum · batch, momentum in
    torch's convention (flax's is 1 − it) — from the batch in fp32; eval
    mode is torch's own.

    Under a data mesh (`mesh`, set by the train step; parallel/mesh.py)
    the training statistics are the GLOBAL batch's, as under JAX's mesh:
    each rank sums x and x² over (N, H, W) with its row count, the sums
    are all-reduced, and the batch is normalized with the global mean and
    the biased variance E[x²] − E[x]² (clipped at 0). The gradient flows
    through the all-reduce: the backward all-reduces Σg and Σg·x̂, so a
    rank's input gradient is that of the global statistics
    (_GlobalBatchNorm). The sums accumulate in fp64 and the backward takes
    the centred form, as F.batch_norm's does: autograd through
    E[x²] − E[x]² in fp32 would lose ~1e-4 of the gradient of the conv
    before the norm to cancellation."""

    mesh = None
    # False while a rematerialized loss recomputes its forward
    # (frozen_running_statistics): the first pass updated the statistics
    update_running = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None and self.mesh.distributed:
            return self._global_batch_forward(x)
        if BatchNorm2d.update_running:
            with torch.no_grad():
                xf = x.float()
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if not BatchNorm2d.update_running:
            return
        with torch.no_grad():
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + self.momentum * mean)
            self.running_var.copy_(decay * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        channels = x.shape[1]
        with torch.no_grad():
            xd = x.double()
            rows = torch.full((1,), x.numel() // channels, dtype=torch.float64,
                              device=x.device)
            sums = self.mesh.all_reduce_(torch.cat(
                [xd.sum(dim=(0, 2, 3)), (xd * xd).sum(dim=(0, 2, 3)), rows]))
            del xd
            count = sums[2 * channels]
            mean = sums[:channels] / count
            var = torch.clamp(sums[channels:2 * channels] / count - mean * mean, min=0.0)
            self._update_running(mean.float(), var.float())
            invstd = torch.rsqrt(var + self.eps).float()
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, mean.float(), invstd,
                                      count, self.mesh)


@contextlib.contextmanager
def frozen_running_statistics():
    """Within: every BatchNorm2d normalizes as before but leaves its
    running statistics alone (the recompute of a checkpointed loss, whose
    first pass updated them)."""
    previous = BatchNorm2d.update_running
    BatchNorm2d.update_running = False
    try:
        yield
    finally:
        BatchNorm2d.update_running = previous


class _GlobalBatchNorm(torch.autograd.Function):
    """y = x̂ · weight + bias with x̂ = (x − mean) · invstd, the global
    batch's statistics given; the backward is F.batch_norm's, its two
    batch sums over the mesh:

        dx = weight · invstd · (g − Σg / n − x̂ · Σ(g·x̂) / n)

    (n the global row count, a 0-dim fp64 tensor: no host sync; Σ over
    every rank's rows), and the local
    dweight = Σ(g·x̂), dbias = Σg, which the step's gradient average sums
    over the ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, count, mesh):
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.count, ctx.mesh, ctx.dtype = count, mesh, x.dtype
        return (xhat * weight[:, None, None] + bias[:, None, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        xhat, weight, invstd = ctx.saved_tensors
        g = grad.float()
        dbias = g.sum(dim=(0, 2, 3), dtype=torch.float64)
        dweight = (g * xhat).sum(dim=(0, 2, 3), dtype=torch.float64)
        sums = ctx.mesh.all_reduce_(torch.cat([dbias, dweight]))
        channels = xhat.shape[1]
        mean_g = (sums[:channels] / ctx.count).float()
        mean_gx = (sums[channels:] / ctx.count).float()
        dx = (g - mean_g[:, None, None] - xhat * mean_gx[:, None, None]) * (
            weight * invstd)[:, None, None]
        return (dx.to(ctx.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype),
                None, None, None, None)


class Banded:
    """A module that runs on a band of the image's rows under a spatial
    `mesh` (set by trainer.bind_spatial), at `level` (its input 2**level
    times smaller than the image, set by its net), for an image `height`
    rows tall (set by its net's forward: set_image_height). Under a
    spatial mesh both must be set (spatial.on_bands raises otherwise)."""

    mesh = None
    level = None
    height = None

    def on_bands(self, level) -> bool:
        """spatial.on_bands at `level` of this module's image."""
        return on_bands(self.mesh, self.height, level)

    def band_rows(self):
        """Every band's row count at this module's level (the halo's)."""
        return level_rows(self.mesh, self.height, self.level)


def set_image_height(net: nn.Module, x: torch.Tensor, height) -> None:
    """Under a spatial mesh of `net` (a Banded depth net): check that x
    [B, C, R, W] is this rank's band of an image `height` rows tall and
    set that height on every Banded module of the net. Nothing without a
    spatial axis."""
    if not row_sharded(net.mesh):
        return
    if height is None:
        raise ValueError(f"{type(net).__name__} on a band of rows needs the image's height")
    rows = net.mesh.band(height)
    if x.shape[2] != rows.stop - rows.start:
        raise ValueError(f"{x.shape[2]} rows: band {rows.start}:{rows.stop} of a "
                         f"{height}-row image was expected")
    for m in net.modules():
        if isinstance(m, Banded):
            m.height = height


def _out_level(level, stride: int):
    return None if level is None else level + stride.bit_length() - 1


def _banded(x: torch.Tensor, mesh, kernel: int, stride: int, padding: int,
            border: float, rows) -> torch.Tensor:
    """x, this rank's band, extended by the rows a (kernel, stride,
    padding) window reads across the band's edges: `padding` rows above
    and kernel − stride − padding below, from the neighbouring bands
    (past a short one: `rows`, every band's row count), or `border` rows
    where the image ends (the layer's own padding, all `padding` rows of
    it below the last band). The window then runs with no row padding: a
    band at a banded level starts at an even row of its input
    (spatial.banded_level), so its stride-2 outputs are exactly the
    image's output rows of that band. Only the last band may hold an odd
    row count; it ends where the image does, and the bottom padding gives
    it the image's last output row."""
    if x.shape[2] % stride and not last_band(mesh):
        raise ValueError(f"a band of {x.shape[2]} rows under a stride-{stride} window")
    above, below = padding, max(kernel - stride - padding, 0)
    bottom = padding if last_band(mesh) else below
    got_above, got_below = halo_reach(mesh, above, below, rows)
    x = halo(x, mesh, above, below, rows)
    pad = (0, 0, above - got_above, bottom - got_below)
    return F.pad(x, pad, value=border) if any(pad) else x


def _cpu_bf16(x: torch.Tensor) -> bool:
    """Does a convolution of x run in bf16 on the CPU?"""
    return x.device.type == "cpu" and (
        x.dtype == torch.bfloat16
        or (torch.is_autocast_enabled("cpu")
            and torch.get_autocast_dtype("cpu") == torch.bfloat16))


def conv2d(conv: nn.Conv2d, x: torch.Tensor, padding) -> torch.Tensor:
    """F.conv2d of x with `conv`'s weights, stride, dilation and groups
    and the (rows, columns) zero `padding`.

    A strided window over a map one column wide pads explicitly where the
    conv runs in bf16 on the CPU: there oneDNN's weight gradient of the
    implicitly padded conv reads memory it never wrote (NaN, 1e36, or
    values that change from run to run; PoseNet's last convs meet it at
    32x64 images). The explicit zeros give the same sums."""
    if conv.stride[1] > 1 and x.shape[3] == 1 and any(padding) and _cpu_bf16(x):
        x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
        padding = (0, 0)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, padding, conv.dilation,
                    conv.groups)


class StridedConv2d(nn.Conv2d):
    """nn.Conv2d run through conv2d: the pose nets' strided convs, which
    see whole frames (no Banded: bind_spatial leaves them alone)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self, x, self.padding)


class Conv2d(Banded, StridedConv2d):
    """nn.Conv2d (through conv2d); under a row-sharding `mesh` its rows
    come with halos (_banded, zero rows at the image's border; a window
    dilated by d reads d·(k − 1) + 1 rows, so BTS's 3x3 ASPP convs take d
    rows each side), or where its output level is not banded it runs on
    the whole map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on_bands(_out_level(self.level, self.stride[0])):
            return super().forward(whole(x, self.mesh, self.height, self.level))
        reach = self.dilation[0] * (self.kernel_size[0] - 1) + 1
        x = _banded(x, self.mesh, reach, self.stride[0], self.padding[0], 0.0,
                    self.band_rows())
        return conv2d(self, x, (0, self.padding[1]))


class MaxPool2d(Banded, nn.MaxPool2d):
    """nn.MaxPool2d; under a row-sharding `mesh` its rows come with halos
    (_banded, −inf rows at the image's border), or where its output level
    is not banded it runs on the whole map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on_bands(_out_level(self.level, self.stride)):
            return super().forward(whole(x, self.mesh, self.height, self.level))
        x = _banded(x, self.mesh, self.kernel_size, self.stride, self.padding, -math.inf,
                    self.band_rows())
        return F.max_pool2d(x, self.kernel_size, self.stride, (0, self.padding))


class AvgPool2d(Banded, nn.AvgPool2d):
    """nn.AvgPool2d(2, 2) (JAX's nn.avg_pool, VALID: a last odd row is
    dropped). Under a row-sharding `mesh` a band at a banded output level
    starts at an even row, so its windows are the image's and need no
    halo; where its output level is not banded it runs on the whole map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on_bands(_out_level(self.level, self.stride)):
            return super().forward(whole(x, self.mesh, self.height, self.level))
        x = _banded(x, self.mesh, self.kernel_size, self.stride, self.padding, 0.0,
                    self.band_rows())
        return F.avg_pool2d(x, self.kernel_size, self.stride, (0, self.padding))


class ConvTranspose2d(Banded, nn.ConvTranspose2d):
    """nn.ConvTranspose2d (JAX's TorchConvTranspose: k 3, stride 2,
    padding 1, output_padding 1 — output 2x the input). Under a
    row-sharding `mesh`, on a band of n rows: output row 2i reads input
    row i and row 2i + 1 reads rows i and i + 1, so the band takes one
    row of the band below (halo) — a zero row at the image's bottom,
    which is the output_padding row's — and its 2n output rows are the
    image's output rows of the band. Where its input level is not
    banded it runs on the whole map and cuts this rank's band out of the
    output where that level is banded (spatial.placed)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on_bands(self.level):
            return placed(super().forward(x), self.mesh, self.height,
                          None if self.level is None else self.level - 1)
        if (self.kernel_size[0], self.stride[0], self.padding[0],
                self.output_padding[0]) != (3, 2, 1, 1):
            raise ValueError("a banded ConvTranspose2d takes kernel 3, stride 2, padding 1, "
                             "output_padding 1 (JAX's TorchConvTranspose)")
        rows = self.band_rows()
        got_below = halo_reach(self.mesh, 0, 1, rows)[1]
        x = halo(x, self.mesh, 0, 1, rows)
        if not got_below:
            x = F.pad(x, (0, 0, 0, 1))
        y = F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                               (0, self.output_padding[1]), self.groups, self.dilation)
        return y[:, :, :2 * (x.shape[2] - 1)]


class GroupNorm(Banded, nn.GroupNorm):
    """nn.GroupNorm. Under a row-sharding
    `mesh` each (image, group)'s statistics are its band's Σx, Σx² and
    count summed over the data row (Mesh.spatial_sum: differentiable, one
    all-reduce; per image, so not over the data axis), accumulated in
    fp64 — autograd through E[x²] − E[x]² in fp32 would lose ~1e-4 of
    the gradient to cancellation — and the band normalized with them, in
    train and eval mode alike. At a level that is not banded, and without
    a mesh, it is its parent."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on_bands(self.level):
            return super().forward(x)
        batch, groups = x.shape[0], self.num_groups
        xg = x.float().reshape(batch, groups, -1)
        xd = xg.double()
        count = torch.full((1,), float(xg.shape[2]), dtype=torch.float64, device=x.device)
        sums = self.mesh.spatial_sum(torch.cat(
            [xd.sum(dim=2).reshape(-1), (xd * xd).sum(dim=2).reshape(-1), count]))
        del xd
        n = batch * groups
        mean = sums[:n] / sums[-1]
        var = torch.clamp(sums[n:2 * n] / sums[-1] - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + self.eps)
        y = (xg - mean.float().reshape(batch, groups, 1)) * invstd.float().reshape(
            batch, groups, 1)
        y = y.reshape(x.shape)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        autocast = torch.is_autocast_enabled(x.device.type)
        return y if autocast else y.to(x.dtype)


def conv(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
         bias: bool = True, level=None, dilation: int = 1) -> Conv2d:
    """Conv2d with torch's symmetric padding, dilation·(k-1)//2 (JAX's
    TorchConv; with a dilation, flax's nn.Conv padded (d, d) as BTS's ASPP
    builds it) at `level` (Banded)."""
    layer = Conv2d(in_channels, out_channels, kernel_size, stride,
                   dilation * (kernel_size - 1) // 2, dilation=dilation, bias=bias)
    layer.level = level
    return layer


def avg_pool(level=None) -> AvgPool2d:
    """AvgPool2d(2, 2) at input `level` (Banded)."""
    layer = AvgPool2d(2, 2)
    layer.level = level
    return layer


def conv_transpose(in_channels: int, out_channels: int, level=None) -> ConvTranspose2d:
    """JAX's TorchConvTranspose: ConvTranspose2d(k=3, stride=2, padding=1,
    output_padding=1), output = 2x the input size, at input `level`
    (Banded)."""
    layer = ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1,
                            output_padding=1)
    layer.level = level
    return layer


def group_norm(channels: int, level=None) -> GroupNorm:
    """GroupNorm(16) with flax's epsilon at `level` (Banded)."""
    layer = GroupNorm(16, channels, eps=GN_EPS)
    layer.level = level
    return layer


def _next(level):
    return None if level is None else level + 1


class DownsampleConvBN(nn.Sequential):
    """Conv(s2) + ReLU + BatchNorm + Conv(s1) + ReLU: the DispNetS encoder
    block, its norm after the activation (the reference's order); its
    input at `level`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 level=None):
        super().__init__(
            conv(in_channels, out_channels, kernel_size, stride=2, level=level), nn.ReLU(),
            BatchNorm2d(out_channels, eps=1e-5, momentum=0.1),
            conv(out_channels, out_channels, kernel_size, level=_next(level)), nn.ReLU(),
        )


class DownsampleConvGN(nn.Sequential):
    """Conv(s2) + GroupNorm(16) + ReLU + Conv(s1) + GroupNorm(16) + ReLU;
    its input at `level`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 level=None):
        out = _next(level)
        super().__init__(
            conv(in_channels, out_channels, kernel_size, stride=2, level=level),
            group_norm(out_channels, out), nn.ReLU(),
            conv(out_channels, out_channels, kernel_size, level=out),
            group_norm(out_channels, out), nn.ReLU(),
        )


class UpconvGN(nn.Sequential):
    """ConvTranspose(3, s2) + GroupNorm(16) + ReLU; its input at `level`."""

    def __init__(self, in_channels: int, out_channels: int, level=None):
        out = None if level is None else level - 1
        super().__init__(conv_transpose(in_channels, out_channels, level),
                         group_norm(out_channels, out), nn.ReLU())


class Conv3x3(Banded, nn.Module):
    """Reflection-pad-1 + 3x3 conv (parameters under ``.conv``) at `level`.
    Under a row-sharding `mesh` the rows above and below the band are the
    neighbouring bands' and the reflection is taken at the image's top
    and bottom only: image row 1 (−2) may lie in the band below (above)
    when a band holds one row, so it is read after the exchange. At a
    level that is not banded it runs on the whole map."""

    def __init__(self, in_channels: int, out_channels: int, level=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3)
        self.level = level

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on_bands(self.level):
            return self.conv(reflect_pad1(x))
        x = halo(x, self.mesh, 1, 1, self.band_rows())
        if first_band(self.mesh):
            x = torch.cat([x[:, :, 1:2], x], dim=2)
        if last_band(self.mesh):
            x = torch.cat([x, x[:, :, -2:-1]], dim=2)
        x = F.pad(x, (1, 1, 0, 0), mode="reflect") if x.shape[3] > 1 else x.expand(
            -1, -1, -1, 3)
        return self.conv(x)


class ConvBlock(nn.Module):
    """Conv3x3 (reflect pad) + ELU (parameters under ``.conv.conv``) at
    `level`."""

    def __init__(self, in_channels: int, out_channels: int, level=None):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels, level)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


def torch_default_init_(conv: nn.Module, generator: torch.Generator) -> None:
    """torch's default conv init — kernel and bias from U(±1/sqrt(fan_in))
    — drawn from `generator`. fan_in is weight[0].numel(): cin·k·k for a
    Conv2d, cout·k·k for a ConvTranspose2d (whose weight is [cin, cout, k,
    k]), as torch computes it."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init (nn.Conv, nn.Dense): a normal truncated
    at ±2 std, variance 1/fan_in after the truncation, fan_in =
    weight[0].numel() (a Linear's in-width, a conv's cin·k·k)."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_module_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of a model whose convs all take torch's default (JAX's
    TorchConv / TorchConvTranspose init) and whose norms start at unit
    scale and zero shift; modules in turn of model.modules()."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                torch_default_init_(m, generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.reset_parameters()
