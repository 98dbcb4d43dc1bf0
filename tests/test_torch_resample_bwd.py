"""The fixed-order backward of the port's bilinear resize
(ops/resample._ResizeBilinear) against torch's own backward of the same
F.interpolate, against jax.vjp of the JAX package's resize_bilinear, and
under torch.autograd.gradcheck.

torch's CUDA backward of F.interpolate adds with atomics, so its bits
change from run to run; the port's gathers each input pixel's readers and
sums them as a fixed tree of elementwise adds, the same bits on every
device and in every run. The forward is F.interpolate's, bit for bit.

Shapes: the loss's integer upsamples by 2, 4, 8 and 16
(losses/reprojection._full_res_depth, DispNetS' x2), a band's halo slab
(one coarse row each side, cropped), non-integer resizes of a whole map
(BtsModel's coarse maps at heights that are no multiple of the factor) and
downsamples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unsupervised_pseuso_lidar_tpu.ops.resample import resize_bilinear as jax_resize
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear

torch.set_num_threads(1)

# (coarse H, W) -> (H, W)
SHAPES = {
    "x2": ((24, 40), (48, 80)),
    "x4": ((12, 20), (48, 80)),
    "x8": ((6, 10), (48, 80)),
    "x16": ((3, 5), (48, 80)),
    "slab_x2": ((6, 16), (12, 32)),  # a 4-row band of DispNetS' up2 + halo
    "slab_x8": ((10, 12), (80, 96)),  # an 8-row band of scale 3 + halo
    "rows_13_to_100": ((13, 12), (100, 96)),  # 1/8 of 100 rows, whole
    "rows_12_to_94": ((12, 10), (94, 80)),
    "down": ((10, 6), (7, 33)),
    "down_both": ((20, 30), (7, 11)),
}
# the port's gradient against torch's backward of the same forward: the
# same products, summed in another order (rel L2; fp32 measured <= 6e-7)
GRAD_RTOL = 1e-6
# against jax.vjp of JAX's interpolation-matrix einsums at fp32 HIGHEST:
# tests/test_torch_geometry.py::test_resize_bilinear_matches_jax's bound
JAX_ATOL = 1e-5


def _inputs(case, seed, dtype=torch.float32):
    (h, w), (out_h, out_w) = SHAPES[case]
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(2, 1, h, w, generator=gen, dtype=torch.float64) * 5 + 0.5
    g = torch.randn(2, 1, out_h, out_w, generator=gen, dtype=torch.float64)
    return x.to(dtype), g.to(dtype), (out_h, out_w)


def _grad(fn, x, g):
    leaf = x.clone().requires_grad_()
    out = fn(leaf)
    (dx,) = torch.autograd.grad(out, leaf, g)
    return out.detach(), dx


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_gradient_is_torch_s_in_a_fixed_order(case):
    # forward bit for bit F.interpolate's; the gradient within GRAD_RTOL
    # of torch's own backward (the parent formula's autograd), within
    # 1e-13 in fp64, and the same bits on a second call
    for dtype, rtol in ((torch.float32, GRAD_RTOL), (torch.float64, 1e-13)):
        x, g, size = _inputs(case, 11, dtype)
        out, dx = _grad(lambda t: resize_bilinear(t, *size), x, g)
        want, ref = _grad(lambda t: F.interpolate(t, size=size, mode="bilinear",
                                                  align_corners=False), x, g)
        assert torch.equal(out, want)
        assert dx.dtype == dtype and dx.shape == x.shape
        assert _rel_l2(dx, ref) <= rtol, (dtype, _rel_l2(dx, ref))
        assert torch.equal(_grad(lambda t: resize_bilinear(t, *size), x, g)[1], dx)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_gradient_matches_jax_vjp(case):
    x, g, size = _inputs(case, 12)
    _, dx = _grad(lambda t: resize_bilinear(t, *size), x, g)
    nhwc = np.moveaxis(x.numpy(), 1, -1)
    _, vjp = jax.vjp(lambda t: jax_resize(t, *size), jnp.asarray(nhwc))
    (ref,) = vjp(jnp.asarray(np.moveaxis(g.numpy(), 1, -1)))
    np.testing.assert_allclose(np.moveaxis(dx.numpy(), 1, -1), np.asarray(ref),
                               atol=JAX_ATOL)


@pytest.mark.parametrize("coarse, size", [((3, 4), (6, 8)), ((2, 3), (8, 12)),
                                           ((5, 3), (13, 7)), ((7, 6), (3, 4))],
                         ids=["x2", "x4", "non_integer", "down"])
def test_gradcheck_in_fp64(coarse, size):
    gen = torch.Generator().manual_seed(13)
    x = torch.rand(1, 2, *coarse, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: resize_bilinear(t, *size), (x,))


@pytest.mark.parametrize("scale", [1, 3])
def test_a_band_slab_s_inner_rows_take_the_whole_map_s_gradient_bit_for_bit(scale):
    # _full_res_depth's slab: a band of coarse rows with one halo row each
    # side, upsampled by f = 2^s and cropped f rows at each end. A coarse
    # row whose readers all lie in the band's output rows gathers the same
    # readers with the same weights in the same order as on the whole map
    f = 2 ** scale
    gen = torch.Generator().manual_seed(14 + scale)
    x = torch.rand(2, 1, 12, 10, generator=gen) + 0.5
    g = torch.randn(2, 1, 12 * f, 10 * f, generator=gen)
    _, whole = _grad(lambda t: resize_bilinear(t, 12 * f, 10 * f), x, g)
    lo, hi = 4, 9  # the band's coarse rows
    slab = x[:, :, lo - 1:hi + 1]
    kept = g[:, :, lo * f:hi * f]

    def band(t):
        return resize_bilinear(t, t.shape[2] * f, 10 * f)[:, :, f:-f]

    _, dx = _grad(band, slab, kept)
    assert torch.equal(dx[:, :, 2:-2], whole[:, :, lo + 1:hi - 1])


def test_bf16_under_autocast_folds_in_fp32():
    # a bf16 map (DispNetS' coarse disparity under the bf16 step's
    # autocast) keeps F.interpolate's bf16 forward; its gradient is the
    # fp32 fold of the bf16 cotangent rounded once to bf16, within one
    # bf16 rounding of torch's bf16 backward
    x, g, size = _inputs("x2", 15)
    x, g = x.bfloat16(), g.bfloat16()
    with torch.autocast("cpu", torch.bfloat16):
        out, dx = _grad(lambda t: resize_bilinear(t, *size), x, g)
        want, ref = _grad(lambda t: F.interpolate(t, size=size, mode="bilinear",
                                                  align_corners=False), x, g)
    assert torch.equal(out, want) and dx.dtype == torch.bfloat16
    _, exact = _grad(lambda t: resize_bilinear(t, *size), x.float(), g.float())
    assert torch.equal(dx, exact.bfloat16())
    assert bool(((dx.float() - ref.float()).abs() <= 2 ** -8 * ref.float().abs()).all())
