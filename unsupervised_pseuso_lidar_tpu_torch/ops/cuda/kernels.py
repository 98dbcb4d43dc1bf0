"""Python wrappers of the CUDA kernels, with their launch counts.

A wrapper given CPU tensors runs the kernel's plain PyTorch version (the
only reason it ever does); given CUDA tensors it checks them, allocates
the output, launches the kernel on the current stream and raises if the
launch failed. ``launch_counts`` counts launches only — a run can read it
to show that its path went through the kernels.

No gradients yet: the wrappers refuse inputs that require grad.
"""

from __future__ import annotations

from typing import Dict

import torch

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import grid_sample
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import C1, C2, photometric_map

KERNELS = ("warp_bilinear_fwd", "ssim_fwd")
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: no gradient path yet (input requires grad)")


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{name}: needs contiguous float32 tensors on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {code}")


def warp_bilinear_fwd(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Kernel A: bilinear sample of img [J, 3, H, W] at normalized grid
    [J, H, W, 2] (align_corners=True, zeros padding) -> [J, 3, H, W]."""
    _refuse_grad("warp_bilinear_fwd", img, grid)
    if not img.is_cuda:
        return grid_sample(img, grid)
    from unsupervised_pseuso_lidar_tpu_torch.ops.cuda.build import load_libraries

    jobs, channels, height, width = img.shape
    if channels != 3 or grid.shape != (jobs, height, width, 2):
        raise ValueError(
            f"warp_bilinear_fwd: img {tuple(img.shape)} must be [J, 3, H, W] "
            f"and grid {tuple(grid.shape)} [J, H, W, 2]"
        )
    for t in (img, grid):
        _check("warp_bilinear_fwd", t, img.device)
    lib = load_libraries()["warp_bilinear"]
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    code = lib.warp_bilinear_fwd(
        img.data_ptr(), grid.data_ptr(), out.data_ptr(),
        jobs, height, width, img.device.index, stream,
    )
    _raise_on_error("warp_bilinear_fwd", code)
    launch_counts["warp_bilinear_fwd"] += 1
    return out


def ssim_fwd(
    x: torch.Tensor, y: torch.Tensor, ssim_weight: float = 1.0
) -> torch.Tensor:
    """Kernel B: per-pixel SSIM distance of NCHW x, y, blended as
    ssim_weight * ssim + (1 - ssim_weight) * |y - x| when ssim_weight < 1."""
    _refuse_grad("ssim_fwd", x, y)
    if not x.is_cuda:
        return photometric_map(x, y, ssim_weight)
    from unsupervised_pseuso_lidar_tpu_torch.ops.cuda.build import load_libraries

    if x.ndim != 4 or y.shape != x.shape:
        raise ValueError(
            f"ssim_fwd: x {tuple(x.shape)} and y {tuple(y.shape)} must be "
            "equal NCHW shapes"
        )
    for t in (x, y):
        _check("ssim_fwd", t, x.device)
    batch, channels, height, width = x.shape
    if batch * channels > 65535:
        raise ValueError("ssim_fwd: at most 65535 planes per launch")
    lib = load_libraries()["ssim"]
    out = torch.empty_like(x)
    blend = ssim_weight < 1.0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.ssim_fwd(
        x.data_ptr(), y.data_ptr(), out.data_ptr(),
        batch * channels, height, width, C1, C2,
        ssim_weight, 1.0 - ssim_weight, int(blend), x.device.index, stream,
    )
    _raise_on_error("ssim_fwd", code)
    launch_counts["ssim_fwd"] += 1
    return out
