"""Port parity: the plain versions of kernels A (bilinear warp) and B (SSIM
distance) and the other resampling ops, against the JAX package — its
jnp ops and its Pallas kernels in interpret mode.

The same numpy inputs go to both packages; images are NHWC on the JAX
side and NCHW on the port's. The CUDA kernels themselves run only on the
card and are held against these plain versions by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.ops import resample as jax_resample
from unsupervised_pseuso_lidar_tpu.ops.pallas.photometric import (
    photometric_map_pallas,
    ssim_distance_pallas,
)
from unsupervised_pseuso_lidar_tpu.ops.pallas.warp import (
    col_coverage,
    grid_sample_mxu_fused,
)
from unsupervised_pseuso_lidar_tpu.ops.ssim import ssim_distance as jax_ssim
from unsupervised_pseuso_lidar_tpu_torch.ops import resample, ssim
from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels

torch.set_num_threads(1)
RNG = np.random.default_rng(11)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _grid(batch, height, width, flow_x, flow_y, rng=RNG):
    xs = np.linspace(-1, 1, width)
    ys = np.linspace(-1, 1, height)
    base = np.stack(np.meshgrid(xs, ys), axis=-1)[None]
    flow = np.stack(
        [rng.uniform(-flow_x, flow_x, (batch, height, width)),
         rng.uniform(-flow_y, flow_y, (batch, height, width))],
        axis=-1,
    )
    return (base + flow).astype(np.float32)


GRID_CASES = {
    # coords inside the frame
    "inside": lambda: _grid(2, 12, 20, 0.05, 0.05) * 0.9,
    # exactly on the border rows/columns (-1 and +1) and just past them
    "border": lambda: np.clip(_grid(2, 12, 20, 0.3, 0.3), -1.0, 1.0)
    + RNG.choice([0.0, 0.0, 1e-3, -1e-3], (2, 12, 20, 2)).astype(np.float32),
    # far outside the frame, including huge values
    "far_outside": lambda: np.concatenate(
        [_grid(1, 12, 20, 0.1, 0.1) * 7.0,
         RNG.choice([-1e7, -40.0, 3.0, 1e9], (1, 12, 20, 2)).astype(np.float32)],
        axis=0,
    ),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_sample_matches_jax_gather(case):
    # the plain version of kernel A vs the exact JAX gather warp: same
    # fp32 bilinear arithmetic, atol 1e-5
    img = RNG.uniform(0, 1, (2, 12, 20, 3)).astype(np.float32)
    grid = GRID_CASES[case]()
    ref = jax_resample.grid_sample(jnp.asarray(img), jnp.asarray(grid))
    got = resample.grid_sample(_nchw(img), torch.from_numpy(grid))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_grid_sample_matches_pallas_fused_warp():
    # JAX kernel A (interpret mode) samples bf16 image planes inside its
    # row/column windows; at small flow its windows keep every tap
    # (col_coverage == 1), so it equals the exact warp up to bf16 rounding
    # of [0, 1] pixel values: atol 2e-2
    img = RNG.uniform(0, 1, (2, 16, 128, 3)).astype(np.float32)
    grid = _grid(2, 16, 128, 0.2, 0.15)
    assert float(col_coverage(jnp.asarray(grid), None, 8, 12)) == 1.0
    ref = grid_sample_mxu_fused(jnp.asarray(img), jnp.asarray(grid), 12, 8, True)
    got = resample.grid_sample(_nchw(img), torch.from_numpy(grid))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=2e-2)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 1, 5, 3), (1, 17, 21, 2)])
def test_ssim_distance_matches_jax(shape):
    # plain version of kernel B vs JAX ssim_distance: the same fp32 ops
    # in the same order, atol 1e-6
    x = RNG.uniform(0, 1, shape).astype(np.float32)
    y = RNG.uniform(0, 1, shape).astype(np.float32)
    ref = jax_ssim(jnp.asarray(x), jnp.asarray(y))
    got = ssim.ssim_distance(_nchw(x), _nchw(y))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("ssim_weight", [1.0, 0.85])
def test_photometric_map_matches_pallas(ssim_weight):
    # JAX kernel B in interpret mode (vertical box pass first, the port
    # horizontal first): atol 1e-5, the JAX package's own kernel tolerance
    x = RNG.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    y = RNG.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    if ssim_weight == 1.0:
        ref = ssim_distance_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True)
    else:
        ref = photometric_map_pallas(
            jnp.asarray(x), jnp.asarray(y), ssim_weight, interpret=True
        )
    got = ssim.photometric_map(_nchw(x), _nchw(y), ssim_weight)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_wrappers_run_plain_versions_on_cpu():
    # on CPU tensors the kernel wrappers ARE the plain versions (bitwise),
    # and launch nothing
    kernels.reset_launch_counts()
    img = torch.from_numpy(RNG.uniform(0, 1, (3, 3, 8, 10)).astype(np.float32))
    grid = torch.from_numpy(_grid(3, 8, 10, 0.2, 0.2))
    assert torch.equal(kernels.warp_bilinear_fwd(img, grid),
                       resample.grid_sample(img, grid))
    x, y = img, img.flip(-1).contiguous()
    for w in (1.0, 0.85):
        assert torch.equal(kernels.ssim_fwd(x, y, w),
                           ssim.photometric_map(x, y, w))
        assert torch.equal(ssim.ssim_distance_fused(x, y, w),
                           ssim.photometric_map(x, y, w))
    assert kernels.launch_counts == {"warp_bilinear_fwd": 0, "ssim_fwd": 0}


def test_wrappers_refuse_gradients():
    img = torch.zeros(1, 3, 4, 4, requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        kernels.warp_bilinear_fwd(img, torch.zeros(1, 4, 4, 2))
    with pytest.raises(ValueError, match="gradient"):
        kernels.ssim_fwd(img, torch.zeros(1, 3, 4, 4))


@pytest.mark.parametrize("shape", [(1, 4, 6, 2), (2, 1, 5, 3), (1, 3, 1, 1)])
def test_reflect_pad1_matches_jax(shape):
    # includes size-1 dims, which replicate (the JAX/numpy rule)
    x = RNG.normal(size=shape).astype(np.float32)
    ref = jax_resample.reflect_pad1(jnp.asarray(x))
    got = resample.reflect_pad1(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


def test_upsample2x_nearest_matches_jax():
    x = RNG.normal(size=(2, 3, 5, 4)).astype(np.float32)
    ref = jax_resample.upsample2x_nearest(jnp.asarray(x))
    got = resample.upsample2x_nearest(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
