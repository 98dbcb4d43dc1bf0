"""SSIM structural-similarity distance (NCHW).

Counterpart of unsupervised_pseuso_lidar_tpu/ops/ssim.py (ssim_distance
:33, ssim_distance_fused :66): 3x3 average pooling at stride 1 over
reflection-padded inputs, C1=1e-4, C2=9e-4, clamp((1 - ssim) / 2, 0, 1).

`photometric_map` is the PLAIN version of kernel B (ops/cuda/ssim.cu),
with the optional 0.85·SSIM + 0.15·L1 blend the kernel also fuses. The
kernel performs this arithmetic in this order — box sums as (a + b + c)
/ 3, horizontal pass first — so the two agree to the last bit, even in
flat regions where sigma is far below C2 and the SSIM ratio amplifies
any difference in the moments. The division by 3 is a true division on
every device (utils/numerics.div), as in JAX and in the kernels: the
plain version gives the same bits on the CPU as on the card.

`photometric_map_bwd` is the PLAIN version of kernel C
(ops/cuda/ssim_bwd.cu), the gradient of photometric_map, in the kernel's
op order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unsupervised_pseuso_lidar_tpu_torch.ops.resample import reflect_pad1
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import div

C1 = 1e-4
C2 = 9e-4


def _box3x3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean filter with reflection padding (separable: rows, then
    columns), output the same size as the NCHW input."""
    pad = reflect_pad1(x)
    horiz = div(pad[..., :-2] + pad[..., 1:-1] + pad[..., 2:], 3.0)
    return div(horiz[..., :-2, :] + horiz[..., 1:-1, :] + horiz[..., 2:, :], 3.0)


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


def _box1d_adjoint(g: torch.Tensor, dim: int) -> torch.Tensor:
    """Adjoint of the reflect-padded length-3 mean along `dim` (one pass of
    _box3x3_reflect): the zero-padded mean of g plus the two reflect
    folds. The pad entries -1 and L copied entries 1 and L-2 (both 0 when
    L == 1, where the pad replicates), so g at 0 and at L-1 also lands
    there. Op order of the JAX kernel's _box1d_adjoint (ops/pallas/
    photometric.py): mean first, then + fold / 3."""
    length = g.shape[dim]
    pad = (1, 1) if dim in (-1, g.ndim - 1) else (0, 0, 1, 1)
    gp = F.pad(g, pad)
    out = div(gp.narrow(dim, 0, length) + gp.narrow(dim, 1, length)
              + gp.narrow(dim, 2, length), 3.0)
    fold = torch.zeros_like(g)
    fold.narrow(dim, min(1, length - 1), 1).add_(g.narrow(dim, 0, 1))
    fold.narrow(dim, max(length - 2, 0), 1).add_(g.narrow(dim, length - 1, 1))
    return out + div(fold, 3.0)


def _box3x3_reflect_adjoint(g: torch.Tensor) -> torch.Tensor:
    # the two passes commute; the W adjoint first, as the JAX kernel
    # composes them (_box3x3_reflect_adjoint_2d)
    return _box1d_adjoint(_box1d_adjoint(g, -1), -2)


def photometric_map_bwd(
    x: torch.Tensor,
    y: torch.Tensor,
    g: torch.Tensor,
    ssim_weight: float = 1.0,
    need_dx: bool = True,
    need_dy: bool = True,
    c1: float = C1,
    c2: float = C2,
):
    """(dx, dy) of sum(g · photometric_map(x, y, ssim_weight)); the one not
    asked for is None.

    The PLAIN version of kernel C (ops/cuda/ssim_bwd.cu), written out as
    the math of the JAX kernel _ssim_bwd_kernel (ops/pallas/photometric.py)
    term for term — moments, g_a…g_d, the reflect-fold adjoint of the box
    — with the moments in kernel B's order (rows, then columns). Its tie
    rules are the JAX ones:

      * the clamp passes the cotangent only where 0 < raw < 1 (the
        kernel's rule; raw == 0 means bit-identical windows);
      * the L1 term of the blend uses jnp.abs' rule, d|z|/dz = +1 at
        z = y - x >= 0 and -1 below (torch.sign would give 0 at a tie).
    """
    m1 = _box3x3_reflect(x)
    m2 = _box3x3_reflect(y)
    p1 = _box3x3_reflect(x * x)
    p2 = _box3x3_reflect(y * y)
    p3 = _box3x3_reflect(x * y)
    mu_xy = m1 * m2
    a = 2.0 * mu_xy + c1
    b = 2.0 * (p3 - mu_xy) + c2
    c = m1 * m1 + m2 * m2 + c1
    d = p1 + p2 - m1 * m1 - m2 * m2 + c2
    s = (a * b) / (c * d)
    raw = (1.0 - s) / 2.0
    blend = ssim_weight < 1.0
    g_ssim = ssim_weight * g if blend else g
    g_s = torch.where((raw > 0.0) & (raw < 1.0), g_ssim, 0.0) * -0.5
    inv_cd = 1.0 / (c * d)
    g_a = g_s * b * inv_cd
    g_b = g_s * a * inv_cd
    g_c = -g_s * s / c
    g_d = -g_s * s / d
    g_ab = g_a - g_b
    g_cd = g_c - g_d
    # g_p1 = g_p2 = g_d, g_p3 = 2 g_b
    t_pd = _box3x3_reflect_adjoint(g_d)
    t_p3 = _box3x3_reflect_adjoint(2.0 * g_b)
    if blend:
        g_l1 = (1.0 - ssim_weight) * g
        g_z = torch.where(y - x >= 0.0, g_l1, -g_l1)
    dx = dy = None
    if need_dx:
        t_m1 = _box3x3_reflect_adjoint(2.0 * (m2 * g_ab + m1 * g_cd))
        dx = t_m1 + 2.0 * x * t_pd + y * t_p3
        if blend:
            dx = dx - g_z
    if need_dy:
        t_m2 = _box3x3_reflect_adjoint(2.0 * (m1 * g_ab + m2 * g_cd))
        dy = t_m2 + 2.0 * y * t_pd + x * t_p3
        if blend:
            dy = dy + g_z
    return dx, dy


def ssim_distance_fused(
    x: torch.Tensor, y: torch.Tensor, ssim_weight: float = 1.0
) -> torch.Tensor:
    """photometric_map with its gradient, through the Photometric autograd
    Function: kernel B forward, kernel C backward. Its wrappers route on
    the device alone: CUDA tensors launch the kernels (fp32 only — they
    raise on any other dtype), CPU tensors run the plain versions."""
    from unsupervised_pseuso_lidar_tpu_torch.ops.cuda.kernels import photometric

    return photometric(x, y, ssim_weight)
