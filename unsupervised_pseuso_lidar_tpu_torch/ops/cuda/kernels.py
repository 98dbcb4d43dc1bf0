"""Python wrappers of the CUDA kernels, with their launch counts, and the
autograd Functions built from them.

A wrapper given CPU tensors runs the kernel's plain PyTorch version (the
only reason it ever does); given CUDA tensors it checks them, allocates
the output, launches the kernel on the current stream and raises if the
launch failed. ``launch_counts`` counts launches only — a run can read it
to show that its path went through the kernels.

The wrappers are raw launches: they build no autograd graph, so they
refuse inputs that require grad while grad mode is on. The differentiable
ops are ``warp_bilinear`` (kernel A forward, A′ backward) and
``photometric`` (kernel B forward, kernel C backward).
"""

from __future__ import annotations

from typing import Dict

import torch

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import (
    grid_sample,
    grid_sample_grad_grid,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import (
    C1,
    C2,
    photometric_map,
    photometric_map_bwd,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import div

KERNELS = ("warp_bilinear_fwd", "warp_bilinear_bwd", "ssim_fwd", "ssim_bwd")
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: input requires grad, and a raw launch would drop its "
            "gradient; use warp_bilinear / photometric"
        )


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{name}: needs contiguous float32 tensors on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {code}")


def _library(name: str):
    from unsupervised_pseuso_lidar_tpu_torch.ops.cuda.build import load_libraries

    return load_libraries()[name]


def _check_warp(name: str, img: torch.Tensor, grid: torch.Tensor, *more) -> None:
    jobs, channels = img.shape[:2]
    if (img.ndim != 4 or channels != 3 or grid.ndim != 4 or grid.shape[0] != jobs
            or grid.shape[3] != 2):
        raise ValueError(
            f"{name}: img {tuple(img.shape)} must be [J, 3, H, W] "
            f"and grid {tuple(grid.shape)} [J, Hg, Wg, 2]"
        )
    if any(t.shape != (jobs, 3, *grid.shape[1:3]) for t in more):
        raise ValueError(f"{name}: the cotangent must be [J, 3, Hg, Wg], the output's shape")
    for t in (img, grid, *more):
        _check(name, t, img.device)


def warp_bilinear_fwd(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Kernel A: bilinear sample of img [J, 3, H, W] at normalized grid
    [J, Hg, Wg, 2] (align_corners=True, zeros padding) -> [J, 3, Hg, Wg].
    The grid may be a band of rows of a row-sharded image (Hg < H)."""
    _refuse_autograd("warp_bilinear_fwd", img, grid)
    if not img.is_cuda:
        return grid_sample(img, grid)
    _check_warp("warp_bilinear_fwd", img, grid)
    jobs, _, height, width = img.shape
    out_h, out_w = grid.shape[1:3]
    out = img.new_empty((jobs, 3, out_h, out_w))
    stream = torch.cuda.current_stream(img.device).cuda_stream
    code = _library("warp_bilinear").warp_bilinear_fwd(
        img.data_ptr(), grid.data_ptr(), out.data_ptr(),
        jobs, height, width, out_h, out_w, img.device.index, stream,
    )
    _raise_on_error("warp_bilinear_fwd", code)
    launch_counts["warp_bilinear_fwd"] += 1
    return out


def warp_bilinear_bwd_grid(
    img: torch.Tensor, grid: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Kernel A′: the gradient of sum(g · warp(img, grid)) w.r.t. grid
    [J, Hg, Wg, 2], img [J, 3, H, W] held fixed; g like the warp's output
    [J, 3, Hg, Wg]."""
    _refuse_autograd("warp_bilinear_bwd_grid", img, grid, g)
    if not img.is_cuda:
        return grid_sample_grad_grid(img, grid, g)
    _check_warp("warp_bilinear_bwd_grid", img, grid, g)
    jobs, _, height, width = img.shape
    out_h, out_w = grid.shape[1:3]
    d_grid = torch.empty_like(grid)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    code = _library("warp_bilinear").warp_bilinear_bwd_grid(
        img.data_ptr(), grid.data_ptr(), g.data_ptr(), d_grid.data_ptr(),
        jobs, height, width, out_h, out_w, img.device.index, stream,
    )
    _raise_on_error("warp_bilinear_bwd_grid", code)
    launch_counts["warp_bilinear_bwd"] += 1
    return d_grid


def _check_ssim(name: str, x: torch.Tensor, *more: torch.Tensor) -> None:
    if x.ndim != 4 or any(t.shape != x.shape for t in more):
        raise ValueError(
            f"{name}: needs equal NCHW shapes, got {tuple(x.shape)} and "
            f"{[tuple(t.shape) for t in more]}"
        )
    for t in (x, *more):
        _check(name, t, x.device)
    if x.shape[0] * x.shape[1] > 65535:
        raise ValueError(f"{name}: at most 65535 planes per launch")
    if x.shape[2] * x.shape[3] >= 2**31:
        raise ValueError(f"{name}: a plane must hold fewer than 2^31 pixels "
                         "(the kernels index inside a plane in 32 bits)")


def ssim_fwd(
    x: torch.Tensor, y: torch.Tensor, ssim_weight: float = 1.0
) -> torch.Tensor:
    """Kernel B: per-pixel SSIM distance of NCHW x, y, blended as
    ssim_weight * ssim + (1 - ssim_weight) * |y - x| when ssim_weight < 1."""
    _refuse_autograd("ssim_fwd", x, y)
    if not x.is_cuda:
        return photometric_map(x, y, ssim_weight)
    _check_ssim("ssim_fwd", x, y)
    batch, channels, height, width = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _library("ssim").ssim_fwd(
        x.data_ptr(), y.data_ptr(), out.data_ptr(),
        batch * channels, height, width, C1, C2,
        ssim_weight, 1.0 - ssim_weight, int(ssim_weight < 1.0), x.device.index,
        stream,
    )
    _raise_on_error("ssim_fwd", code)
    launch_counts["ssim_fwd"] += 1
    return out


def ssim_bwd(
    x: torch.Tensor,
    y: torch.Tensor,
    g: torch.Tensor,
    ssim_weight: float = 1.0,
    need_dx: bool = True,
    need_dy: bool = True,
):
    """Kernel C: (dx, dy) of sum(g · ssim_fwd(x, y, ssim_weight)); the one
    not asked for is None (and is not computed)."""
    _refuse_autograd("ssim_bwd", x, y, g)
    if not x.is_cuda:
        return photometric_map_bwd(x, y, g, ssim_weight, need_dx, need_dy)
    _check_ssim("ssim_bwd", x, y, g)
    if not (need_dx or need_dy):
        return None, None
    batch, channels, height, width = x.shape
    dx = torch.empty_like(x) if need_dx else None
    dy = torch.empty_like(x) if need_dy else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _library("ssim_bwd").ssim_bwd(
        x.data_ptr(), y.data_ptr(), g.data_ptr(),
        dx.data_ptr() if need_dx else None, dy.data_ptr() if need_dy else None,
        batch * channels, height, width, C1, C2,
        ssim_weight, 1.0 - ssim_weight, int(ssim_weight < 1.0), x.device.index,
        stream,
    )
    _raise_on_error("ssim_bwd", code)
    launch_counts["ssim_bwd"] += 1
    return dx, dy


def div3(x: torch.Tensor) -> torch.Tensor:
    """x / 3 per element through the division helper of kernels B and C
    (ops/cuda/div3.cuh) — for checking it against the IEEE division; the
    plain version is that division. Not a kernel of the main path: no
    launch count."""
    if not x.is_cuda:
        return div(x, 3.0)
    _check("div3", x, x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _library("div3").div3_f32(x.data_ptr(), out.data_ptr(), x.numel(),
                                     x.device.index, stream)
    _raise_on_error("div3", code)
    return out


class WarpBilinear(torch.autograd.Function):
    """Kernel A forward, A′ backward: the gradient flows to grid only
    (called through warp_bilinear, which enforces that)."""

    @staticmethod
    def forward(ctx, img, grid):
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(img, grid)
        return warp_bilinear_fwd(img, grid)

    @staticmethod
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        return None, warp_bilinear_bwd_grid(img, grid, g.contiguous())


class Photometric(torch.autograd.Function):
    """Kernel B forward, kernel C backward; x and y are saved only when a
    gradient is wanted, and only the asked-for gradients are computed."""

    @staticmethod
    def forward(ctx, x, y, ssim_weight):
        ctx.ssim_weight = ssim_weight
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, y)
        return ssim_fwd(x, y, ssim_weight)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dx, dy = ssim_bwd(x, y, g.contiguous(), ctx.ssim_weight,
                          ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dx, dy, None


def warp_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The differentiable warp (kernel A forward, A′ backward).

    The JAX kernel's loud contract (ops/pallas/warp.py _bwd, img_is_data):
    there is no img gradient, so an img that requires grad raises —
    warping a network output would otherwise lose its gradient silently."""
    if torch.is_grad_enabled() and img.requires_grad:
        raise ValueError(
            "warp_bilinear has no gradient w.r.t. img: it warps data frames "
            "only (img must not require grad)"
        )
    return WarpBilinear.apply(img, grid)


def photometric(
    x: torch.Tensor, y: torch.Tensor, ssim_weight: float = 1.0
) -> torch.Tensor:
    """The differentiable photometric map (see Photometric)."""
    return Photometric.apply(x, y, ssim_weight)
