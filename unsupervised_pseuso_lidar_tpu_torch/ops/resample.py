"""Resampling primitives (NCHW): bilinear grid sampling, resize, pads.

Counterpart of unsupervised_pseuso_lidar_tpu/ops/resample.py
(reflect_pad1 :24, grid_sample :112, resize_bilinear :352,
upsample2x_nearest :396).

`grid_sample` here is the PLAIN version of kernel A
(ops/cuda/warp_bilinear.cu): a 4-tap gather by integer indexing with the
same arithmetic, in the same order, as the CUDA kernel, so the two agree
to the last bit on the card. The wrapper in ops/cuda/kernels.py runs it
only for CPU tensors.
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


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of `img` at normalized `grid` locations,
    align_corners=True, zeros padding (the warp's semantics).

    Args:
      img: [B, C, H, W] source.
      grid: [B, Ho, Wo, 2] normalized (x, y); -1 -> pixel 0 and
        +1 -> pixel size-1.
    Returns:
      [B, C, Ho, Wo].

    A tap outside the image reads 0. Sample positions are clamped to
    [-2, size+1] before the floor: past that every tap of the pixel is
    outside the image either way, and the clamp keeps far-out-of-frame
    coordinates from overflowing the integer conversion.
    """
    batch, channels, height, width = img.shape
    _, out_h, out_w, _ = grid.shape
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
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

    return (
        tap(x0, y0) * wx0 * wy0
        + tap(x1, y0) * wx1 * wy0
        + tap(x0, y1) * wx0 * wy1
        + tap(x1, y1) * wx1 * wy1
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
