"""Resampling primitives (NCHW): bilinear grid sampling, resize, pads.

Counterpart of unsupervised_pseuso_lidar_tpu/ops/resample.py
(reflect_pad1 :24, grid_sample :112, resize_bilinear :352,
upsample2x_nearest :396).

`grid_sample` here is the PLAIN version of kernel A
(ops/cuda/warp_bilinear.cu): a 4-tap gather by integer indexing with the
same arithmetic, in the same order, as the CUDA kernel, so the two agree
to the last bit on the card. `grid_sample_grad_grid` is the plain version
of the warp's backward kernel in the same file. The wrappers in
ops/cuda/kernels.py run them only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflection-pad H and W of an NCHW map by 1.

    Size-1 dims replicate their single row/column (numpy reflect-mode
    behaviour, like the JAX version; torch's reflection pad would refuse
    them — the decoder's deepest map is 1 pixel tall at small inputs)."""
    if x.shape[2] > 1 and x.shape[3] > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    h_lo = x[:, :, 1:2] if x.shape[2] > 1 else x[:, :, :1]
    h_hi = x[:, :, -2:-1] if x.shape[2] > 1 else x[:, :, -1:]
    x = torch.cat([h_lo, x, h_hi], dim=2)
    w_lo = x[:, :, :, 1:2] if x.shape[3] > 1 else x[:, :, :, :1]
    w_hi = x[:, :, :, -2:-1] if x.shape[3] > 1 else x[:, :, :, -1:]
    return torch.cat([w_lo, x, w_hi], dim=3)


def _bilinear_taps(img: torch.Tensor, grid: torch.Tensor):
    """The 4-tap bilinear sample of `img` [B, C, H, W] at normalized `grid`
    [B, Ho, Wo, 2] (align_corners=True): ((wx0, wx1, wy0, wy1), (v00, v10,
    v01, v11)), weights [B, 1, Ho, Wo] and taps [B, C, Ho, Wo], where v10
    is the tap one pixel right of v00 and v01 the one below it.

    A tap outside the image reads 0. Sample positions are clamped to
    [-2, size+1] before the floor: past that every tap of the pixel is
    outside the image either way, and the clamp keeps far-out-of-frame
    coordinates from overflowing the integer conversion.
    """
    batch, channels, height, width = img.shape
    _, out_h, out_w, _ = grid.shape
    coord_dtype = torch.promote_types(grid.dtype, torch.float32)
    gx = grid[..., 0].to(coord_dtype)
    gy = grid[..., 1].to(coord_dtype)
    x = ((gx + 1.0) * 0.5 * (width - 1)).clamp(-2.0, width + 1.0)
    y = ((gy + 1.0) * 0.5 * (height - 1)).clamp(-2.0, height + 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx1 = (x - x0f).to(img.dtype)[:, None]
    wy1 = (y - y0f).to(img.dtype)[:, None]
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = x0 + 1
    y1 = y0 + 1
    flat = img.reshape(batch, channels, height * width)

    def tap(ix, iy):
        inside = (ix >= 0) & (ix <= width - 1) & (iy >= 0) & (iy <= height - 1)
        idx = iy.clamp(0, height - 1) * width + ix.clamp(0, width - 1)
        idx = idx.reshape(batch, 1, out_h * out_w).expand(-1, channels, -1)
        val = torch.gather(flat, 2, idx).reshape(batch, channels, out_h, out_w)
        return val * inside[:, None].to(img.dtype)

    return (wx0, wx1, wy0, wy1), (tap(x0, y0), tap(x1, y0), tap(x0, y1), tap(x1, y1))


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of `img` at normalized `grid` locations,
    align_corners=True, zeros padding (the warp's semantics).

    Args:
      img: [B, C, H, W] source.
      grid: [B, Ho, Wo, 2] normalized (x, y); -1 -> pixel 0 and
        +1 -> pixel size-1.
    Returns:
      [B, C, Ho, Wo]. Taps outside the image read 0 (see _bilinear_taps).
    """
    (wx0, wx1, wy0, wy1), (v00, v10, v01, v11) = _bilinear_taps(img, grid)
    return v00 * wx0 * wy0 + v10 * wx1 * wy0 + v01 * wx0 * wy1 + v11 * wx1 * wy1


def grid_sample_grad_grid(
    img: torch.Tensor, grid: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Gradient of sum(g · grid_sample(img, grid)) w.r.t. `grid`, with img
    held fixed (it is a data frame): [B, Ho, Wo, 2].

    The PLAIN version of the warp's backward kernel
    (ops/cuda/warp_bilinear.cu, warp_bilinear_bwd_grid), in its op order.
    Per channel d(out)/dx = wy0·(v10 − v00) + wy1·(v11 − v01) and
    d(out)/dy = wx0·(v01 − v00) + wx1·(v11 − v10) over the same taps as
    the forward (outside ones read 0, so where the clamp bites the
    gradient is 0); both are contracted with g over the channels in order
    and scaled by d(pixel)/d(grid) = ½(W − 1), ½(H − 1). This is the JAX
    custom-VJP backward (ops/pallas/warp.py _bwd) applied to the tap
    planes its forward kernel emits.
    """
    (wx0, wx1, wy0, wy1), (v00, v10, v01, v11) = _bilinear_taps(img, grid)
    d_x = wy0 * (v10 - v00) + wy1 * (v11 - v01)
    d_y = wx0 * (v01 - v00) + wx1 * (v11 - v10)
    sum_x = g[:, 0] * d_x[:, 0]
    sum_y = g[:, 0] * d_y[:, 0]
    for c in range(1, img.shape[1]):
        sum_x = sum_x + g[:, c] * d_x[:, c]
        sum_y = sum_y + g[:, c] * d_y[:, c]
    height, width = img.shape[2], img.shape[3]
    return torch.stack(
        [sum_x * (0.5 * (width - 1)), sum_y * (0.5 * (height - 1))], dim=-1
    )


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of an NCHW map (interpolate semantics,
    align_corners=False: half-pixel centers, border clamp)."""
    if img.shape[-2:] == (out_h, out_w):
        return img
    return F.interpolate(
        img, size=(out_h, out_w), mode="bilinear", align_corners=False
    )


def upsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of an NCHW map (each pixel repeated 2x2)."""
    return F.interpolate(img, scale_factor=2, mode="nearest")
