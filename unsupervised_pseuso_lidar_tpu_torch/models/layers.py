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

The blocks are nn.Sequential in the reference's layout, so their
state-dict keys are the reference's (conv1.0 / conv1.2 / conv1.3 for a
DispNetS encoder block, upconv_1.0 / upconv_1.1 for a StnDispNet one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import reflect_pad1


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None and self.mesh.distributed:
            return self._global_batch_forward(x)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
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


def conv(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """nn.Conv2d with torch's symmetric (k-1)//2 padding (JAX's TorchConv)."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                     (kernel_size - 1) // 2, bias=bias)


def conv_transpose(in_channels: int, out_channels: int) -> nn.ConvTranspose2d:
    """JAX's TorchConvTranspose: ConvTranspose2d(k=3, stride=2, padding=1,
    output_padding=1), output = 2x the input size."""
    return nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1,
                              output_padding=1)


class DownsampleConvBN(nn.Sequential):
    """Conv(s2) + ReLU + BatchNorm + Conv(s1) + ReLU: the DispNetS encoder
    block, its norm after the activation (the reference's order)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__(
            conv(in_channels, out_channels, kernel_size, stride=2), nn.ReLU(),
            BatchNorm2d(out_channels, eps=1e-5, momentum=0.1),
            conv(out_channels, out_channels, kernel_size), nn.ReLU(),
        )


class DownsampleConvGN(nn.Sequential):
    """Conv(s2) + GroupNorm(16) + ReLU + Conv(s1) + GroupNorm(16) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__(
            conv(in_channels, out_channels, kernel_size, stride=2),
            nn.GroupNorm(16, out_channels, eps=GN_EPS), nn.ReLU(),
            conv(out_channels, out_channels, kernel_size),
            nn.GroupNorm(16, out_channels, eps=GN_EPS), nn.ReLU(),
        )


class UpconvGN(nn.Sequential):
    """ConvTranspose(3, s2) + GroupNorm(16) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(conv_transpose(in_channels, out_channels),
                         nn.GroupNorm(16, out_channels, eps=GN_EPS), nn.ReLU())


class Conv3x3(nn.Module):
    """Reflection-pad-1 + 3x3 conv (parameters under ``.conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    """Conv3x3 (reflect pad) + ELU (parameters under ``.conv.conv``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

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
