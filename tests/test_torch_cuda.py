"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present, so on a CPU-only host these count as skipped. On a GPU host,
without the JAX package's conftest (the card's machine has no jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py checks the kernels at the production shapes; these cover
the shapes it does not: KITTI-native 375x1242, partial tiles, 1-pixel
dimensions, coordinates far outside the frame, and the wrappers' checks.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import grid_sample
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import (
    photometric_map,
    ssim_distance_fused,
)

pytestmark = pytest.mark.cuda
# kernel vs plain: the same fp32 ops in the same order (--fmad=false), so
# agreement is expected to be exact; the bounds are chip_smoke's
WARP_TOL = 1e-5
SSIM_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _grid(jobs, height, width, gen, device, spread=1.05):
    grid = (torch.rand(jobs, height, width, 2, generator=gen, device=device)
            * 2 - 1) * spread
    # exact borders, just-outside and far-outside/huge coordinates
    specials = torch.tensor([-1.0, 1.0, -1.0001, 1.0001, -40.0, 3.0, 1e9, -1e9],
                            device=device)
    pick = torch.randint(0, 8, grid.shape, generator=gen, device=device)
    use = torch.rand(grid.shape, generator=gen, device=device) < 0.05
    return torch.where(use, specials[pick], grid).contiguous()


@pytest.mark.parametrize(
    "shape", [(2, 375, 1242), (3, 192, 640), (1, 7, 5), (2, 1, 33), (1, 1, 1)]
)
def test_warp_kernel_matches_plain(cuda, shape):
    jobs, height, width = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    img = torch.randn(jobs, 3, height, width, generator=gen, device=cuda)
    grid = _grid(jobs, height, width, gen, cuda)
    before = kernels.launch_counts["warp_bilinear_fwd"]
    got = kernels.warp_bilinear_fwd(img, grid)
    assert kernels.launch_counts["warp_bilinear_fwd"] == before + 1
    err = float((got - grid_sample(img, grid)).abs().max())
    assert err <= WARP_TOL, err
    if min(height, width) > 1:
        # the library op agrees to rounding (it orders the weights
        # differently)
        lib = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        assert float((got - lib).abs().max()) <= 1e-4


@pytest.mark.parametrize(
    "shape", [(2, 3, 375, 1242), (1, 3, 33, 65), (1, 2, 1, 37), (2, 1, 1, 1)]
)
@pytest.mark.parametrize("weight", [1.0, 0.85])
def test_ssim_kernel_matches_plain(cuda, shape, weight):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.rand(shape, generator=gen, device=cuda)
    # y close to x in places, so flat low-variance windows occur
    y = torch.where(torch.rand(shape, generator=gen, device=cuda) < 0.5, x,
                    torch.rand(shape, generator=gen, device=cuda))
    before = kernels.launch_counts["ssim_fwd"]
    got = kernels.ssim_fwd(x, y, weight)
    assert kernels.launch_counts["ssim_fwd"] == before + 1
    err = float((got - photometric_map(x, y, weight)).abs().max())
    assert err <= SSIM_TOL, err


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    img = torch.zeros(1, 3, 8, 8, device=cuda)
    grid = torch.zeros(1, 8, 8, 2, device=cuda)
    with pytest.raises(ValueError):
        kernels.warp_bilinear_fwd(img.transpose(2, 3), grid)  # not contiguous
    with pytest.raises(ValueError):
        kernels.warp_bilinear_fwd(img.double(), grid.double())
    with pytest.raises(ValueError):
        kernels.warp_bilinear_fwd(torch.zeros(1, 4, 8, 8, device=cuda), grid)
    with pytest.raises(ValueError):
        kernels.ssim_fwd(img, img.cpu())


def test_fused_ssim_routes_only_fp32_to_the_kernel(cuda):
    x = torch.rand(1, 3, 16, 16, device=cuda)
    before = dict(kernels.launch_counts)
    # a CUDA tensor never falls back to the plain version: bf16 raises
    with pytest.raises(ValueError, match="float32"):
        ssim_distance_fused(x.bfloat16(), x.bfloat16())
    assert kernels.launch_counts == before
    ssim_distance_fused(x, x)
    assert kernels.launch_counts["ssim_fwd"] == before["ssim_fwd"] + 1
    np.testing.assert_allclose(
        ssim_distance_fused(x, x).cpu().numpy(), 0.0, atol=1e-6
    )
