"""Resampling primitives (NCHW): bilinear grid sampling, resize, pads.

Counterpart of unsupervised_pseuso_lidar_tpu/ops/resample.py
(reflect_pad1 :24, grid_sample :112, resize_bilinear :352,
resize_nearest :385, upsample2x_nearest :396).

`grid_sample` here (align_corners=True, the warp's convention) is the
PLAIN version of kernel A
(ops/cuda/warp_bilinear.cu): a 4-tap gather by integer indexing with the
same arithmetic, in the same order, as the CUDA kernel, so the two agree
to the last bit on the card. `grid_sample_grad_grid` is the plain version
of the warp's backward kernel in the same file. The wrappers in
ops/cuda/kernels.py run them only for CPU tensors.

`reflect_pad1` and `resize_bilinear` keep torch's forward and give their
gradients a fixed-order backward of their own: torch's CUDA backwards of
both add with atomics, whose order, and so whose bits, change from run to
run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


class _ReflectPad1(torch.autograd.Function):
    """F.pad(x, (1, 1, 1, 1), mode="reflect") of a map with H, W >= 2,
    whose backward folds the padded rows, then the padded columns, back
    onto the rows and columns they copy, in that fixed order: torch's own
    backward adds them with atomics on CUDA, in an order that changes from
    run to run, so two runs of a step (a captured and an eager one) would
    part in the last bits of a border pixel's gradient."""

    @staticmethod
    def forward(ctx, x):
        return F.pad(x, (1, 1, 1, 1), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        rows = g[:, :, 1:-1].clone()  # padded row 0 copies row 1, row H+1 row H-2
        rows[:, :, 1] += g[:, :, 0]
        rows[:, :, -2] += g[:, :, -1]
        out = rows[:, :, :, 1:-1].clone()
        out[:, :, :, 1] += rows[:, :, :, 0]
        out[:, :, :, -2] += rows[:, :, :, -1]
        return out


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflection-pad H and W of an NCHW map by 1 (_ReflectPad1: its
    gradient has the same bits in every run).

    Size-1 dims replicate their single row/column (numpy reflect-mode
    behaviour, like the JAX version; torch's reflection pad would refuse
    them — the decoder's deepest map is 1 pixel tall at small inputs)."""
    if x.shape[2] > 1 and x.shape[3] > 1:
        return _ReflectPad1.apply(x)
    h_lo = x[:, :, 1:2] if x.shape[2] > 1 else x[:, :, :1]
    h_hi = x[:, :, -2:-1] if x.shape[2] > 1 else x[:, :, -1:]
    x = torch.cat([h_lo, x, h_hi], dim=2)
    w_lo = x[:, :, :, 1:2] if x.shape[3] > 1 else x[:, :, :, :1]
    w_hi = x[:, :, :, -2:-1] if x.shape[3] > 1 else x[:, :, :, -1:]
    return torch.cat([w_lo, x, w_hi], dim=3)


def _bilinear_taps(img: torch.Tensor, grid: torch.Tensor, align_corners: bool = True):
    """The 4-tap bilinear sample of `img` [B, C, H, W] at normalized `grid`
    [B, Ho, Wo, 2]: ((wx0, wx1, wy0, wy1), (v00, v10, v01, v11)), weights
    [B, 1, Ho, Wo] and taps [B, C, Ho, Wo], where v10 is the tap one pixel
    right of v00 and v01 the one below it. align_corners=True maps -1 and
    +1 to the centers of the edge pixels, False to their outer edges.

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
    if align_corners:
        x = (gx + 1.0) * 0.5 * (width - 1)
        y = (gy + 1.0) * 0.5 * (height - 1)
    else:
        x = ((gx + 1.0) * width - 1.0) * 0.5
        y = ((gy + 1.0) * height - 1.0) * 0.5
    x = x.clamp(-2.0, width + 1.0)
    y = y.clamp(-2.0, height + 1.0)
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


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """Bilinear sampling of `img` at normalized `grid` locations, zeros
    padding (F.grid_sample's mode='bilinear' semantics).

    Args:
      img: [B, C, H, W] source.
      grid: [B, Ho, Wo, 2] normalized (x, y); with align_corners -1 ->
        pixel 0 and +1 -> pixel size-1 (the warp's convention), without
        -1 -> -0.5 and +1 -> size-0.5.
    Returns:
      [B, C, Ho, Wo]. Taps outside the image read 0 (see _bilinear_taps).
    """
    (wx0, wx1, wy0, wy1), (v00, v10, v01, v11) = _bilinear_taps(img, grid, align_corners)
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


def _bilinear_source(in_size: int, out_size: int, dtype):
    """The taps of a bilinear resize along one axis (align_corners=False):
    for each output index o, (i0, i1, l0, l1) with out[o] = l0·in[i0] +
    l1·in[i1], in torch's arithmetic (upsample's
    compute_source_index_and_lambda): src = (in / out)·(o + ½) − ½,
    clamped at 0; i0 = ⌊src⌋, i1 = i0 + 1 but at the last index; l1 =
    src − i0, l0 = 1 − l1, each rounded in `dtype` (numpy)."""
    half = dtype(0.5)
    scale = dtype(in_size) / dtype(out_size)
    src = np.maximum(scale * (np.arange(out_size, dtype=dtype) + half) - half, dtype(0))
    i0 = src.astype(np.int64)
    i1 = i0 + (i0 < in_size - 1)
    l1 = src - i0.astype(dtype)
    return i0, i1, dtype(1) - l1, l1


@functools.lru_cache(maxsize=None)
def _readers(in_size: int, out_size: int, dtype: torch.dtype, device: torch.device):
    """The transpose of _bilinear_source, as gather tables: for each input
    index i, the outputs whose taps read it with a weight other than 0, in
    ascending order (i0's tap before i1's where both read i), padded with
    weight 0 to a power of two K: (index [K·in] long, weight [K, in] `dtype`), on `device`, made
    once from the static sizes (a CUDA graph's replay copies nothing)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    i0, i1, l0, l1 = _bilinear_source(in_size, out_size, np_dtype)
    taps = [[] for _ in range(in_size)]
    for o in range(out_size):
        for i, w in ((i0[o], l0[o]), (i1[o], l1[o])):
            if w:  # a tap of weight 0 adds nothing
                taps[i].append((o, w))
    k = 1 << (max(map(len, taps)) - 1).bit_length()
    index = np.zeros((k, in_size), np.int64)
    weight = np.zeros((k, in_size), np_dtype)
    for i, read in enumerate(taps):
        if read:
            index[:, i] = read[0][0]  # the padding re-reads a real tap
        for j, (o, w) in enumerate(read):
            index[j, i], weight[j, i] = o, w
    return (torch.from_numpy(index.reshape(-1)).to(device),
            torch.from_numpy(weight).to(device=device, dtype=dtype))


def _fold(g: torch.Tensor, dim: int, in_size: int) -> torch.Tensor:
    """The adjoint of a bilinear resize of `in_size` to g.shape[dim] along
    `dim`: each input index gathers its readers' cotangents
    (index_select), weights them and sums them as a fixed pairwise tree
    of elementwise adds, the same bits on every device."""
    index, weight = _readers(in_size, g.shape[dim], g.dtype, g.device)
    k = weight.shape[0]
    shape = list(g.shape)
    shape[dim:dim + 1] = [k, in_size]
    terms = g.index_select(dim, index).view(shape) * weight.view(
        [k, in_size] + [1] * (g.dim() - dim - 1))
    while k > 1:
        k //= 2
        terms = terms.narrow(dim, 0, k) + terms.narrow(dim, k, k)
    return terms.squeeze(dim)


def resize_bilinear_grad(g: torch.Tensor, height: int, width: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """The gradient of resize_bilinear w.r.t. a `height` x `width` map of
    `dtype`, given the cotangent g of its output: g folded back along W,
    then along H (_fold), in fp32 (fp64 for an fp64 map)."""
    g = g.to(torch.float64 if g.dtype == torch.float64 else torch.float32)
    if g.shape[3] != width:
        g = _fold(g, 3, width)
    if g.shape[2] != height:
        g = _fold(g, 2, height)
    return g.to(dtype)


class _ResizeBilinear(torch.autograd.Function):
    """F.interpolate's bilinear resize (align_corners=False) of an NCHW
    map with resize_bilinear_grad as its backward. torch's own backward
    adds with atomics on CUDA, in an order that changes from run to run,
    so two runs of a multi-scale step would part in the last bits of the
    coarse maps' gradients."""

    @staticmethod
    def forward(ctx, img, out_h, out_w):
        ctx.in_shape, ctx.dtype = img.shape, img.dtype
        return F.interpolate(
            img, size=(out_h, out_w), mode="bilinear", align_corners=False
        )

    @staticmethod
    def backward(ctx, g):
        return resize_bilinear_grad(g, *ctx.in_shape[-2:], ctx.dtype), None, None


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of an NCHW map (interpolate semantics,
    align_corners=False: half-pixel centers, border clamp). Its gradient
    (_ResizeBilinear) has the same bits in every run and on every
    device; the forward is F.interpolate's."""
    if img.shape[-2:] == (out_h, out_w):
        return img
    return _ResizeBilinear.apply(img, out_h, out_w)


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW map: source index
    floor(i · (in / out)) in fp32, clipped to the map (JAX's formula,
    computed as written; the index tensors depend on the static sizes
    only)."""
    height, width = img.shape[-2:]
    iy = torch.floor(torch.arange(out_h, dtype=torch.float32, device=img.device)
                     * (height / out_h)).long().clamp(0, height - 1)
    ix = torch.floor(torch.arange(out_w, dtype=torch.float32, device=img.device)
                     * (width / out_w)).long().clamp(0, width - 1)
    return img[:, :, iy][:, :, :, ix]


def upsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of an NCHW map (each pixel repeated 2x2)."""
    return F.interpolate(img, scale_factor=2, mode="nearest")
