"""SSIM structural-similarity distance (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/ops/ssim.py (ssim_distance
:33, ssim_distance_fused :66): 3x3 average pooling at stride 1 over
reflection-padded inputs, C1=1e-4, C2=9e-4, clamp((1 - ssim) / 2, 0, 1).

`photometric_map` is the PLAIN version of kernel B (ops/cuda/ssim.cu),
with the optional 0.85·SSIM + 0.15·L1 blend the kernel also fuses. The
kernel performs this arithmetic in this order — box sums as (a + b + c)
/ 3, horizontal pass first — so on the card the two agree to rounding,
even in flat regions where sigma is far below C2 and the SSIM ratio
amplifies any difference in the moments. (On CUDA, PyTorch computes
`tensor / python_scalar` as a multiply by the reciprocal; the kernel does
the same. On the CPU it is a true division, like JAX's.)
"""

from __future__ import annotations

import torch

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import reflect_pad1

C1 = 1e-4
C2 = 9e-4


def _box3x3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean filter with reflection padding (separable: rows, then
    columns), output the same size as the NCHW input."""
    pad = reflect_pad1(x)
    horiz = (pad[..., :-2] + pad[..., 1:-1] + pad[..., 2:]) / 3.0
    return (horiz[..., :-2, :] + horiz[..., 1:-1, :] + horiz[..., 2:, :]) / 3.0


def ssim_distance(
    x: torch.Tensor, y: torch.Tensor, c1: float = C1, c2: float = C2
) -> torch.Tensor:
    """Per-pixel SSIM distance clamp((1 - SSIM(x, y)) / 2, 0, 1) between
    two NCHW images."""
    mu_x = _box3x3_reflect(x)
    mu_y = _box3x3_reflect(y)
    mu_xy = mu_x * mu_y
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y

    sigma_x = _box3x3_reflect(x * x) - mu_xx
    sigma_y = _box3x3_reflect(y * y) - mu_yy
    sigma_xy = _box3x3_reflect(x * y) - mu_xy

    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    ssim = num / den
    return torch.clamp((1.0 - ssim) / 2.0, 0.0, 1.0)


def photometric_map(
    x: torch.Tensor, y: torch.Tensor, ssim_weight: float = 1.0
) -> torch.Tensor:
    """ssim_weight · ssim_distance(x, y) + (1 - ssim_weight) · |y - x|
    (just the SSIM distance at ssim_weight >= 1)."""
    ssim = ssim_distance(x, y)
    if ssim_weight >= 1.0:
        return ssim
    return ssim_weight * ssim + (1.0 - ssim_weight) * torch.abs(y - x)


def ssim_distance_fused(
    x: torch.Tensor, y: torch.Tensor, ssim_weight: float = 1.0
) -> torch.Tensor:
    """photometric_map through kernel B's wrapper, which routes on the
    device alone: CUDA tensors launch the kernel (fp32 only — it raises on
    any other dtype), CPU tensors run the plain version."""
    from unsupervised_pseuso_lidar_tpu_torch.ops.cuda.kernels import ssim_fwd

    return ssim_fwd(x, y, ssim_weight)
