"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present, so on a CPU-only host these count as skipped. On a GPU host,
without the JAX package's conftest (the card's machine has no jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py checks the kernels at the production shapes; these cover
the shapes it does not: KITTI-native 375x1242, partial tiles, the edges
of the warp strips and row segments of kernels B and C, 1- and 2-pixel
dimensions, coordinates far outside the frame, the autograd Functions,
the wrappers' checks, and the division helper of B and C on a binade and
the subnormals.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import (
    grid_sample,
    grid_sample_grad_grid,
    resize_bilinear,
)
from unsupervised_pseuso_lidar_tpu_torch.ops.ssim import (
    photometric_map,
    photometric_map_bwd,
    ssim_distance_fused,
)

pytestmark = pytest.mark.cuda
# kernel vs plain: the same fp32 ops in the same order (--fmad=false), so
# agreement is expected to be exact; the bounds are chip_smoke's. The
# backward bounds are relative to the gradient's largest entry: dx of the
# SSIM grows as 1/(c·d) in flat windows, so no absolute bound holds
WARP_TOL = 1e-5
SSIM_TOL = 2e-5
BWD_RTOL = 1e-5


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


@pytest.mark.parametrize(
    "shape", [(2, 375, 1242), (3, 192, 640), (1, 7, 5), (2, 1, 33), (1, 2, 1), (1, 1, 1)]
)
def test_warp_bwd_kernel_matches_plain(cuda, shape):
    jobs, height, width = shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    img = torch.randn(jobs, 3, height, width, generator=gen, device=cuda)
    grid = _grid(jobs, height, width, gen, cuda)
    g = torch.randn(jobs, 3, height, width, generator=gen, device=cuda)
    before = kernels.launch_counts["warp_bilinear_bwd"]
    got = kernels.warp_bilinear_bwd_grid(img, grid, g)
    assert kernels.launch_counts["warp_bilinear_bwd"] == before + 1
    ref = grid_sample_grad_grid(img, grid, g)
    assert got.shape == grid.shape
    err = float((got - ref).abs().max())
    assert err <= BWD_RTOL * max(float(ref.abs().max()), 1e-30), err


@pytest.mark.parametrize("shape", [(3, 192, 640), (2, 384, 1280)])
@pytest.mark.parametrize("band", [0, 1])
def test_warp_kernels_on_a_band_of_grid_rows_match_plain(cuda, shape, band):
    # a spatial mesh's warp: the grid is a band of Hg = H/2 rows of the
    # target (band 0 or 1 of 2) over the whole image; A and A′ equal their
    # plain versions bit for bit there, and the band's rows of the whole
    # grid's warp and grid gradient
    jobs, height, width = shape
    gen = torch.Generator(device=cuda).manual_seed(6)
    img = torch.randn(jobs, 3, height, width, generator=gen, device=cuda)
    grid = _grid(jobs, height, width, gen, cuda)
    g = torch.randn(jobs, 3, height, width, generator=gen, device=cuda)
    rows = slice(band * height // 2, (band + 1) * height // 2)
    band_grid, band_g = grid[:, rows].contiguous(), g[:, :, rows].contiguous()
    before = dict(kernels.launch_counts)
    out = kernels.warp_bilinear_fwd(img, band_grid)
    d_grid = kernels.warp_bilinear_bwd_grid(img, band_grid, band_g)
    assert kernels.launch_counts["warp_bilinear_fwd"] == before["warp_bilinear_fwd"] + 1
    assert kernels.launch_counts["warp_bilinear_bwd"] == before["warp_bilinear_bwd"] + 1
    assert out.shape == (jobs, 3, height // 2, width) and d_grid.shape == band_grid.shape
    assert torch.equal(out, grid_sample(img, band_grid))
    assert torch.equal(d_grid, grid_sample_grad_grid(img, band_grid, band_g))
    assert torch.equal(out, kernels.warp_bilinear_fwd(img, grid)[:, :, rows])
    assert torch.equal(d_grid, kernels.warp_bilinear_bwd_grid(img, grid, g)[:, rows])


@pytest.mark.parametrize("shape,rows", [((3, 96, 640), (64, 96)), ((3, 80, 640), (64, 80)),
                                        ((2, 75, 100), (64, 75)), ((2, 97, 33), (32, 65))])
def test_warp_kernels_on_an_uneven_band_of_grid_rows_match_plain(cuda, shape, rows):
    # the bands of the 32-row grain (parallel/mesh.row_bands): the grid is
    # rows [start, stop) of the target — 32 of 96, 16 of 80, an odd 11 of
    # 75, 33 of 97 — over the whole image; A and A′ equal their plain
    # versions bit for bit there, and the band's rows of the whole grid's
    # warp and grid gradient
    jobs, height, width = shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    img = torch.randn(jobs, 3, height, width, generator=gen, device=cuda)
    grid = _grid(jobs, height, width, gen, cuda)
    g = torch.randn(jobs, 3, height, width, generator=gen, device=cuda)
    band = slice(*rows)
    band_grid, band_g = grid[:, band].contiguous(), g[:, :, band].contiguous()
    out = kernels.warp_bilinear_fwd(img, band_grid)
    d_grid = kernels.warp_bilinear_bwd_grid(img, band_grid, band_g)
    assert out.shape == (jobs, 3, rows[1] - rows[0], width)
    assert torch.equal(out, grid_sample(img, band_grid))
    assert torch.equal(d_grid, grid_sample_grad_grid(img, band_grid, band_g))
    assert torch.equal(out, kernels.warp_bilinear_fwd(img, grid)[:, :, band])
    assert torch.equal(d_grid, kernels.warp_bilinear_bwd_grid(img, grid, g)[:, band])


def test_full_res_depth_on_a_band_slab_matches_the_whole_map_on_the_card(cuda, tmp_path):
    # losses/reprojection._full_res_depth on 2 gloo ranks sharing the card,
    # each on its band of a scale-s depth (192 rows over 2: 128 / 64, the
    # 32-row grain) with a coarse halo row each side: the bands' rows vs the
    # whole map's upsample on the card, at scales 1-3, within one rounding
    # of each value; the gradient of sum(out · g) at rel L2 1e-5
    import torch_parallel_worker as worker

    from unsupervised_pseuso_lidar_tpu_torch.losses.reprojection import _full_res_depth

    gen = torch.Generator().manual_seed(9)
    height, width = 192, 640
    inputs = {s: (torch.rand(2, 1, height >> s, width >> s, generator=gen) * 5 + 1,
                  torch.randn(2, height, width, generator=gen)) for s in (1, 2, 3)}
    ranks = worker.run_ranks(worker.band_upsample, 2, tmp_path, inputs, (height, width),
                             device="cuda:0", spatial=2)
    for scale, (coarse, g) in inputs.items():
        leaf = coarse.to(cuda).requires_grad_()
        whole = _full_res_depth(leaf, height, width)
        (whole * g.to(cuda)).sum().backward()
        got = torch.cat([r[scale][0] for r in ranks], dim=1).to(cuda)
        assert got.shape == whole.shape
        assert bool(((got - whole.detach()).abs() <= 2.0 ** -22 * whole.detach().abs()).all())
        grad = torch.cat([r[scale][1] for r in ranks], dim=2).to(cuda).double()
        rel = float(torch.linalg.vector_norm(grad - leaf.grad.double())
                    / torch.linalg.vector_norm(leaf.grad.double()))
        assert rel <= 1e-5, (scale, rel)


@pytest.mark.parametrize(
    "shape", [(2, 3, 375, 1242), (1, 3, 33, 65), (1, 2, 1, 37), (1, 1, 2, 5),
              (1, 2, 34, 2), (2, 1, 1, 1)]
)
@pytest.mark.parametrize("weight", [1.0, 0.85])
@pytest.mark.parametrize("need_dy", [False, True])
def test_ssim_bwd_kernel_matches_plain(cuda, shape, weight, need_dy):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.rand(shape, generator=gen, device=cuda)
    # y equal to x in places: flat windows and exact ties occur
    y = torch.where(torch.rand(shape, generator=gen, device=cuda) < 0.5, x,
                    torch.rand(shape, generator=gen, device=cuda))
    g = torch.randn(shape, generator=gen, device=cuda)
    before = kernels.launch_counts["ssim_bwd"]
    dx, dy = kernels.ssim_bwd(x, y, g, weight, True, need_dy)
    assert kernels.launch_counts["ssim_bwd"] == before + 1
    ref_dx, ref_dy = photometric_map_bwd(x, y, g, weight, True, need_dy)
    assert (dy is None) == (not need_dy)
    for got, ref in ((dx, ref_dx), (dy, ref_dy)):
        if ref is not None:
            err = float((got - ref).abs().max())
            assert err <= BWD_RTOL * max(float(ref.abs().max()), 1e-30), err


def _ssim_inputs(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda")
    y = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5, x,
                    torch.rand(shape, generator=gen, device="cuda"))
    g = torch.randn(shape, generator=gen, device="cuda")
    return x, y, g


# the warp-strip tiling of kernels B and C (ops/cuda/ssim.cu, ssim_bwd.cu):
# a warp writes `strip` columns of one plane and walks `segment` rows
B_STRIP, B_SEGMENT = 62, 48
C_STRIP, C_SEGMENT = 28, 32


def _edges(strip, segment):
    return [(segment - 1, strip - 1), (segment, strip), (segment + 1, strip + 1),
            (2 * segment + 1, 2 * strip - 1), (3, 2 * strip + 1)]


@pytest.mark.parametrize("hw", _edges(C_STRIP, C_SEGMENT))
@pytest.mark.parametrize("weight", [1.0, 0.85])
@pytest.mark.parametrize("need", [(True, False), (False, True), (True, True)],
                         ids=["dx", "dy", "dx_dy"])
def test_ssim_bwd_kernel_at_strip_and_segment_edges(cuda, hw, weight, need):
    x, y, g = _ssim_inputs((1, 2, *hw), seed=6)
    got = kernels.ssim_bwd(x, y, g, weight, *need)
    ref = photometric_map_bwd(x, y, g, weight, *need)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if b is not None:
            err = float((a - b).abs().max())
            assert err <= BWD_RTOL * max(float(b.abs().max()), 1e-30), err


@pytest.mark.parametrize("hw", _edges(B_STRIP, B_SEGMENT))
@pytest.mark.parametrize("weight", [1.0, 0.85])
def test_ssim_kernel_at_strip_and_segment_edges(cuda, hw, weight):
    x, y, _ = _ssim_inputs((1, 2, *hw), seed=7)
    err = float((kernels.ssim_fwd(x, y, weight) - photometric_map(x, y, weight)).abs().max())
    assert err <= SSIM_TOL, err


def test_div3_helper_is_the_ieee_division_on_a_binade_and_the_subnormals(cuda):
    # [1, 2) and every subnormal, both signs (chip_smoke.py covers all 2^32)
    bits = torch.cat([torch.arange(0x3F800000, 0x40000000, device=cuda),
                      torch.arange(0, 0x00800000, device=cuda)]).to(torch.int32)
    x = torch.cat([bits, bits | torch.tensor(-2**31, dtype=torch.int32, device=cuda)])
    x = x.view(torch.float32)
    got = kernels.div3(x)
    want = x / torch.full((), 3.0, device=cuda)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_autograd_functions_launch_the_backward_kernels(cuda):
    # the warped stack's pattern: grid and x require grad, img and y are
    # data; one launch of each kernel, and the gradients of the plain path
    gen = torch.Generator(device=cuda).manual_seed(5)
    img = torch.rand(2, 3, 40, 70, generator=gen, device=cuda)
    target = torch.rand(2, 3, 40, 70, generator=gen, device=cuda)
    grid = _grid(2, 40, 70, gen, cuda, spread=0.9).requires_grad_()
    kernels.reset_launch_counts()
    loss = kernels.photometric(kernels.warp_bilinear(img, grid), target, 0.85).mean()
    (d_grid,) = torch.autograd.grad(loss, grid)
    assert kernels.launch_counts == dict.fromkeys(kernels.KERNELS, 1)
    warped = grid_sample(img, grid.detach())
    g = torch.full_like(warped, 1.0 / warped.numel())
    dx, _ = photometric_map_bwd(warped, target, g, 0.85, True, False)
    ref = grid_sample_grad_grid(img, grid.detach(), dx)
    err = float((d_grid - ref).abs().max())
    assert err <= BWD_RTOL * float(ref.abs().max()), err


def test_backward_wrappers_refuse_img_grad_and_bf16(cuda):
    gen = torch.Generator().manual_seed(3)
    img = torch.rand(1, 3, 8, 8, generator=gen).to(cuda)
    grid = torch.zeros(1, 8, 8, 2, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="gradient"):
        kernels.warp_bilinear(img.clone().requires_grad_(), grid)
    g = torch.rand(1, 3, 8, 8, generator=gen).to(cuda)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="float32"):
        kernels.warp_bilinear_bwd_grid(img, grid.detach(), g.bfloat16())
    with pytest.raises(ValueError, match="float32"):
        kernels.ssim_bwd(img.bfloat16(), img.bfloat16(), g.bfloat16())
    with pytest.raises(ValueError, match="float32"):
        kernels.ssim_bwd(img, img, g.bfloat16())
    assert kernels.launch_counts == before


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
    x = torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(4)).to(cuda)
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


def _small_calib(directory):
    # a camera for 64x96 frames, the real KITTI velodyne->camera rotation
    directory.mkdir()
    (directory / "calib_cam_to_cam.txt").write_text(
        "K_02: 100 0 48 0 100 32 0 0 1\nP_rect_02: 100 0 48 0.5 0 100 32 0.01 0 0 1 0\n"
        "R_rect_02: 1 0 0 0 1 0 0 0 1\n")
    (directory / "calib_velo_to_cam.txt").write_text(
        "R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 7.280733e-04 "
        "-9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02\n"
        "T: -4.069766e-03 -7.631618e-02 -2.717806e-01\n")
    (directory / "calib_imu_to_velo.txt").write_text("R: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n")
    return str(directory)


@pytest.fixture
def fused_on_card(cuda, tmp_path):
    """DispResNet-18 + the projector as one batch-polymorphic program,
    traced on the card at batch 2 and saved; (path, live module)."""
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar import export
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR

    depth = build_model("DispResNet", torch.Generator().manual_seed(0), device=cuda)
    fused = export.make_depth_cloud_fn(
        export.make_depth_fn(depth), PseudoLiDAR(_small_calib(tmp_path / "calib"), device=cuda))
    path = str(tmp_path / "fused.pt2")
    export.export_program(fused, [torch.zeros(2, 64, 96, 3, device=cuda)], path,
                          batch_poly=True)
    return path, fused


@pytest.mark.parametrize("batch", [1, 3])
def test_fused_export_round_trip_on_the_card(fused_on_card, batch):
    # the reloaded program on the card vs the live module at cli.export
    # --verify's bound (2e-5; the valid mask may flip only where a point
    # sits on the crop's edge); no kernel of ops/cuda is on the serving path
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import run_exported

    path, fused = fused_on_card
    gen = torch.Generator(device="cuda").manual_seed(batch)
    img = torch.rand(batch, 64, 96, 3, generator=gen, device="cuda") * 2 - 1
    kernels.reset_launch_counts()
    got = run_exported(path, img)
    with torch.no_grad():
        want = fused(img)
    assert kernels.launch_counts == dict.fromkeys(kernels.KERNELS, 0)
    assert got[1].shape == (batch, 64 * 96, 4) and bool(got[2].any())
    assert all(a.device.type == "cuda" for a in got)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    assert float((got[2] != want[2]).float().mean()) <= 1e-3


def test_run_exported_refuses_a_cpu_input_or_device(fused_on_card):
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import run_exported

    path, _ = fused_on_card
    with pytest.raises(ValueError, match="an input is on cpu"):
        run_exported(path, torch.zeros(1, 64, 96, 3))
    with pytest.raises(ValueError, match="traced on cuda"):
        run_exported(path, np.zeros((1, 64, 96, 3), np.float32), device="cpu")


def test_bf16_autocast_export_on_the_card(cuda, tmp_path):
    # configs/tpu_v5e.yaml serves under bf16 autocast: the autocast region
    # is captured in the program, the weights stay fp32, and the reloaded
    # program matches the live module at 2e-5
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar import export

    depth = build_model("DispResNet", torch.Generator().manual_seed(1), device=cuda)
    fn = export.make_depth_fn(depth, precision="bf16")
    path = str(tmp_path / "bf16.pt2")
    export.export_program(fn, [torch.zeros(2, 64, 96, 3, device=cuda)], path, batch_poly=True)
    program = export.load_exported(path)
    assert all(t.dtype == torch.float32 for t in program.state_dict.values()
               if t.is_floating_point())
    img = torch.rand(1, 64, 96, 3, generator=torch.Generator(device="cuda").manual_seed(3),
                     device="cuda")
    with torch.no_grad():
        want = fn(img)
        fp32 = export.make_depth_fn(depth)(img)
    got = export.run_exported(path, img)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert not torch.equal(want, fp32)  # autocast did run the model in bf16


def test_op_breakdown_of_a_training_step_sees_the_four_kernels(cuda, tmp_path):
    # configs/tpu_v5e.yaml at full width and batch: one profiled step after
    # one of warm-up; CUPTI reports each kernel's launches (the backward's
    # from the autograd engine's thread too), and the device time is real
    from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer
    from unsupervised_pseuso_lidar_tpu_torch.utils.trace import op_breakdown

    config = load_config("configs/tpu_v5e.yaml")
    config.action.checkpoint_dir = str(tmp_path)
    data = SyntheticTripletDataset(1, config.action.batch_size, *config.image_shape,
                                   uint8_images=True)
    trainer = Trainer(config, data, device=cuda)
    batch = {k: torch.as_tensor(v).to(cuda) for k, v in next(iter(data.batches())).items()}
    result = op_breakdown(lambda: trainer.train_step(batch), steps=1, warmup=1,
                          verbose=False)
    assert result.on_device and 0 < result.busy_ms <= result.host_ms
    for family, count in (("warp_bilinear_fwd_kernel", 1), ("warp_bilinear_bwd_grid_kernel", 1),
                          ("ssim_fwd_kernel", 2), ("ssim_bwd_kernel", 1)):
        assert result.counts.get(family) == count, (family, result.counts.get(family))
        assert result[family] > 0


@pytest.mark.parametrize("invert", [False, True])
def test_inverse_warp_on_the_card_matches_the_cpu(cuda, invert):
    from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import inverse_warp

    gen = torch.Generator().manual_seed(4)
    img = torch.randn(2, 3, 96, 160, generator=gen)
    depth = torch.rand(2, 96, 160, generator=gen) * 18 + 2
    pose = torch.randn(2, 6, generator=gen) * torch.tensor([0.02] * 3 + [0.2] * 3)
    K = torch.tensor([[100.0, 0.0, 80.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]])
    want = inverse_warp(img, depth, pose, K, invert_pose=invert)
    before = kernels.launch_counts["warp_bilinear_fwd"]
    got = inverse_warp(img.to(cuda), depth.to(cuda), pose.to(cuda), K.to(cuda),
                       invert_pose=invert)
    assert kernels.launch_counts["warp_bilinear_fwd"] == before + 1
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def test_bts_forward_on_the_card_matches_the_cpu(cuda):
    # BtsModel at the reference ROS node's 352x1216, seeded, eval mode, TF32
    # off: the five outputs on the card vs the CPU at relative L2 1e-5
    # (final depth 80·sigmoid also elementwise at 1e-4 of its range), and
    # no launch of the loss kernels
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model

    torch.backends.cudnn.allow_tf32 = False
    model = build_model("BtsModel", torch.Generator().manual_seed(0), device="cpu").eval()
    img = torch.randn(1, 3, 352, 1216, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(img)
        kernels.reset_launch_counts()
        got = model.to(cuda)(img.to(cuda))
    assert kernels.launch_counts == dict.fromkeys(kernels.KERNELS, 0)
    for g, w in zip(got, want):
        g = g.cpu().double()
        assert g.shape == w.shape == (1, 1, 352, 1216)
        assert float((g - w).norm() / w.double().norm()) <= 1e-5
    assert float((got[4].cpu() - want[4]).abs().max()) <= 1e-4 * 80.0


@pytest.mark.parametrize("model,kwargs,scales", [
    ("DispNetS", {}, 4), ("DispResNet", {"num_layers": 50, "all_scales": True}, 4),
    ("StnDispNet", {"use_stn": True}, 1)])
def test_zoo_training_step_launches_the_kernels_once_a_scale(cuda, model, kwargs, scales):
    # one 'min' step of each depth net on the card launches, per output
    # scale, one warp (A) and its grid gradient (A'), one SSIM pass (B)
    # and its backward (C), plus the identity pass's one B
    from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import synthetic_triplet_batch
    from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )

    config = Config()
    config.model.depth.name, config.model.depth.kwargs = model, kwargs
    config.datasets.augmentation.image_height = 128
    config.datasets.augmentation.image_width = 256
    state = create_train_state(config, torch.Generator().manual_seed(0), device=cuda)
    step = make_train_step(state, device=cuda, loss_mode="min")
    batch = synthetic_triplet_batch(2, 128, 256, seed=0)
    kernels.reset_launch_counts()
    metrics = step(batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert kernels.launch_counts == {"warp_bilinear_fwd": scales, "warp_bilinear_bwd": scales,
                                     "ssim_fwd": scales + 1, "ssim_bwd": scales}


def _seeded_weights():
    """DispResNet-18 + PoseNet weights from a seed (state dicts on the
    CPU), the pose head given a bias that moves the warp by a few pixels,
    as tests/test_torch_train.py's jax_models does: at a fresh
    initialization's near-identity warp every sample sits next to a
    pixel crossing, where the gradient jumps under any 1-ulp change."""
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model

    gen = torch.Generator().manual_seed(0)
    pose = build_model("PoseNet", gen, device="cpu").state_dict()
    scale = torch.tensor([0.005] * 3 + [0.03] * 3).repeat(2)
    pose["pose_pred.bias"] = torch.randn(12, generator=gen) * scale / 0.06
    return {"depth": build_model("DispResNet", gen, device="cpu").state_dict(), "pose": pose}


def _flat_grads(result):
    return torch.cat([g.reshape(-1) for _, g in sorted(result["grads"].items())
                      if g is not None])


@pytest.fixture
def no_tf32(monkeypatch):
    # fp32 convolutions, as on the spawned ranks (torch_parallel_worker)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _one_process_card_step(cuda, weights, mesh=None):
    # imported by its file's name: on the card's machine `tests` is
    # another installed package
    import torch_parallel_worker as worker

    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import make_train_step

    state = worker.make_state(weights, cuda)
    step = make_train_step(state, device=cuda, mesh=mesh, loss_mode="min",
                           **worker.STEP_SETTINGS)
    kernels.reset_launch_counts()
    result = worker.step_result(state, step(worker.step_batch("min")))
    result["launches"] = dict(kernels.launch_counts)
    return result


MIN_STEP_LAUNCHES = {"warp_bilinear_fwd": 1, "warp_bilinear_bwd": 1, "ssim_fwd": 2,
                     "ssim_bwd": 1}


def test_world_one_nccl_step_matches_the_plain_step(cuda, no_tf32):
    # the step under make_mesh(1) of a 1-rank NCCL group vs the plain step
    # from the same weights (64x96, batch 4, 'min'): only the synced
    # BatchNorm's formula (fp64 sums) differs from F.batch_norm's (fp32)
    # -> the gradient at rel L2 <= 1e-4 (chip_smoke's budget; the
    # difference reaches 4e-5 at 1280x384), the four kernels launched as
    # in the plain step
    import torch.distributed as dist

    from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed
    from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import make_mesh

    weights = _seeded_weights()
    plain = _one_process_card_step(cuda, weights)
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device=cuda)
    try:
        assert dist.get_backend() == "nccl"
        meshed = _one_process_card_step(cuda, weights, make_mesh(1, device=cuda))
    finally:
        dist.destroy_process_group()
    rel = float(torch.linalg.vector_norm((_flat_grads(meshed) - _flat_grads(plain)).double())
                / torch.linalg.vector_norm(_flat_grads(plain).double()))
    assert rel <= 1e-4, rel
    assert meshed["launches"] == plain["launches"] == MIN_STEP_LAUNCHES


def test_two_gloo_ranks_sharing_the_card_match_the_one_process_step(cuda, no_tf32, tmp_path):
    # 2 gloo ranks spawned on cuda:0, batch 4 split 2 + 2, one 'min' step
    # vs the one-process step on the whole batch on the card: the loss at
    # rel 2e-4, the all-reduced gradient at rel L2 1e-4, BatchNorm
    # statistics at 1e-5; every rank launches the four kernels
    import torch_parallel_worker as worker

    weights = _seeded_weights()
    ranks = worker.run_ranks(worker.card_step, 2, tmp_path, weights, device="cuda:0")
    ref = _one_process_card_step(cuda, weights)
    for rank in ranks:
        assert rank["launches"] == MIN_STEP_LAUNCHES
        np.testing.assert_allclose(rank["metrics"]["loss"], ref["metrics"]["loss"], rtol=2e-4)
    rel = float(torch.linalg.vector_norm((_flat_grads(ranks[0]) - _flat_grads(ref)).double())
                / torch.linalg.vector_norm(_flat_grads(ref).double()))
    assert rel <= 1e-4, rel
    assert torch.equal(_flat_grads(ranks[0]), _flat_grads(ranks[1]))
    for key, value in ref["stats"].items():
        np.testing.assert_allclose(ranks[0]["stats"][key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


# --------------------------------------------------------------------------
# the step as one program: TrainStep, make_multi_step and EvalStep as CUDA
# graphs (train/graph.py)
# --------------------------------------------------------------------------


def _graph_trainer(cuda, graph, mesh=None, **action):
    from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer

    config = load_config("configs/tpu_v5e.yaml")
    aug = config.datasets.augmentation
    aug.image_height, aug.image_width = 128, 256
    config.action.batch_size = 4
    for key, value in action.items():
        if key in ("color_jitter", "hflip"):
            setattr(aug, key, value)
        else:
            setattr(config.action, key, value)
    return Trainer(config, device=cuda, graph=graph, mesh=mesh)


def _graph_batches(count, seed):
    from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset

    return list(SyntheticTripletDataset(count, 4, 128, 256, seed=seed,
                                        uint8_images=True).batches())


def _trainer_tensors(trainer):
    state = trainer.state
    out = {}
    for net, model in (("depth", state.depth_model), ("pose", state.pose_model)):
        out.update({f"{net}.{k}": v for k, v in model.state_dict().items()})
        out.update({f"{net}.{k}.grad": p.grad for k, p in model.named_parameters()
                    if p.grad is not None})
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in slots.items()})
    return out


@pytest.fixture
def deterministic(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


@pytest.mark.parametrize("action", [
    {"loss_mode": "min"},
    {"loss_mode": "min", "precision": "fp32", "color_jitter": True, "hflip": True,
     "automask_warmup": 2},
    {"loss_mode": "ssim", "precision": "fp32", "accum_steps": 2},
    {"loss_mode": "min", "precision": "fp32", "remat": True},
], ids=["bf16_min", "augment_warmup", "ssim_accum2", "remat"])
def test_captured_train_step_matches_the_eager_step(cuda, deterministic, action):
    # a captured Trainer and an eager one from one seed, 4 steps (the
    # captured one's first runs eagerly, its second captures, the others
    # replay): metrics, parameters, gradients, BatchNorm statistics and
    # Adam's slots equal bit for bit after every step; one graph, replayed
    # 3 times, each replay counting one step's kernel launches
    captured, eager = _graph_trainer(cuda, None, **action), _graph_trainer(cuda, False, **action)
    assert captured.train_step.graphs is not None and eager.train_step.graphs is None
    for i, batch in enumerate(_graph_batches(4, seed=21)):
        kernels.reset_launch_counts()
        got = captured.train_step(batch)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        kernels.reset_launch_counts()
        want = eager.train_step(batch)
        torch.cuda.synchronize()
        assert launches == kernels.launch_counts, (i, launches)
        assert all(torch.equal(got[k], want[k]) for k in want), i
        a, b = _trainer_tensors(captured), _trainer_tensors(eager)
        differ = [k for k in b if not torch.equal(a[k], b[k])]
        assert not differ, (i, differ[:5])
    graphs = captured.train_step.graphs
    assert len(graphs.graphs) == 1 and graphs.replays == 3


@pytest.fixture
def nccl_world_one(cuda):
    """make_mesh(1) over a 1-rank NCCL group in this process."""
    import torch.distributed as dist

    from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed
    from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device=cuda)
    try:
        assert dist.get_backend() == "nccl"
        yield make_mesh(1, device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("action", [
    {"loss_mode": "min", "precision": "fp32"},
    {"loss_mode": "ssim", "precision": "fp32", "accum_steps": 2, "supervised_weight": 0.1},
], ids=["min", "ssim_accum2_supervised"])
def test_world_one_nccl_captured_step_matches_the_eager_step(nccl_world_one, cuda,
                                                             deterministic, action):
    # under an NCCL mesh the step captures by default, its all-reduces in
    # the graph: 4 steps captured against graph=False from one seed, the
    # metrics and the whole state bit for bit; one graph, 3 replays
    mesh = nccl_world_one
    assert mesh.capturable
    captured = _graph_trainer(cuda, None, mesh, **action)
    eager = _graph_trainer(cuda, False, mesh, **action)
    assert captured.train_step.graphs is not None and eager.train_step.graphs is None
    for i, batch in enumerate(_graph_batches(4, seed=26)):
        got, want = captured.train_step(batch), eager.train_step(batch)
        torch.cuda.synchronize()
        assert all(torch.equal(got[k], want[k]) for k in want), i
        a, b = _trainer_tensors(captured), _trainer_tensors(eager)
        differ = [k for k in b if not torch.equal(a[k], b[k])]
        assert not differ, (i, differ[:5])
    graphs = captured.train_step.graphs
    assert len(graphs.graphs) == 1 and graphs.replays == 3


def test_world_one_nccl_captured_multi_and_eval_steps_match_eager(nccl_world_one, cuda,
                                                                 deterministic):
    # make_multi_step(2) under the NCCL mesh, captured against eager over
    # 3 calls, then the mesh's eval step over 3 batches
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
        make_eval_step,
        make_multi_step,
    )

    mesh = nccl_world_one
    owners = [_graph_trainer(cuda, False, mesh, loss_mode="min") for _ in range(2)]
    names = ("loss_mode", "smooth_weight", "smooth_on", "depth_norm", "precision")
    multis = [make_multi_step(o.state, 2, mesh=mesh, device=cuda, graph=graph,
                              **{k: getattr(o.train_step, k) for k in names})
              for o, graph in zip(owners, (None, False))]
    assert multis[0].train_step.graphs is not None and multis[1].train_step.graphs is None
    batches = _graph_batches(6, seed=27)
    for r in range(3):
        chunk = {k: np.stack([b[k] for b in batches[2 * r:2 * r + 2]]) for k in batches[0]}
        got, want = multis[0](chunk), multis[1](chunk)
        assert all(torch.equal(got[k], want[k]) for k in want), r
        a, b = _trainer_tensors(owners[0]), _trainer_tensors(owners[1])
        differ = [k for k in b if not torch.equal(a[k], b[k])]
        assert not differ, (r, differ[:5])
    assert multis[0].train_step.graphs.replays == 2
    state = owners[0].state
    kwargs = dict(loss_mode="min", eval_protocol="eigen", pose_metrics=True, mesh=mesh,
                  device=cuda)
    captured = make_eval_step(state.depth_model, state.pose_model, **kwargs)
    eager = make_eval_step(state.depth_model, state.pose_model, graph=False, **kwargs)
    for batch in batches[:3]:
        (got, depth), (want, want_depth) = captured(batch), eager(batch)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert torch.equal(depth, want_depth)
    assert captured.graphs.replays == 2


def test_captured_step_returns_metrics_no_later_step_overwrites(cuda):
    trainer = _graph_trainer(cuda, None)
    batches = _graph_batches(4, seed=22)
    returned = [trainer.train_step(b) for b in batches]
    values = [{k: v.clone() for k, v in m.items()} for m in returned]
    for b in batches:
        trainer.train_step(b)
    torch.cuda.synchronize()
    for got, kept in zip(returned, values):
        assert all(torch.equal(got[k], kept[k]) for k in kept)
    assert len({float(m["loss"]) for m in values}) == len(values)


def test_captured_eval_step_matches_the_eager_step(cuda):
    # the eval step (Eigen protocol, pose metrics) captured and eager on
    # the same modules: every metric and depth_pred bit for bit; a later
    # call does not overwrite what an earlier one returned
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import make_eval_step

    trainer = _graph_trainer(cuda, None)
    kwargs = dict(loss_mode="min", precision="bf16", eval_protocol="eigen", pose_metrics=True,
                  device=cuda)
    state = trainer.state
    captured = make_eval_step(state.depth_model, state.pose_model, **kwargs)
    eager = make_eval_step(state.depth_model, state.pose_model, graph=False, **kwargs)
    outputs = []
    for batch in _graph_batches(4, seed=23):
        (got, depth), (want, want_depth) = captured(batch), eager(batch)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert torch.equal(depth, want_depth)
        outputs.append((got, depth, {k: v.clone() for k, v in got.items()}, depth.clone()))
    for got, depth, kept, kept_depth in outputs:
        assert all(torch.equal(got[k], kept[k]) for k in kept)
        assert torch.equal(depth, kept_depth)
    assert captured.graphs.replays == 3


def test_multi_step_is_one_replay_of_three_steps(cuda, deterministic):
    # make_multi_step(num_steps=3) against 3 captured single steps from
    # one seed, 3 rounds (eager, capture, replay): the same state bit for
    # bit; one graph, each replay one launch for 3 updates
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import make_multi_step

    action = {"loss_mode": "min", "automask_warmup": 4, "color_jitter": True, "hflip": True}
    single, owner = _graph_trainer(cuda, None, **action), _graph_trainer(cuda, None, **action)
    names = ("loss_mode", "smooth_weight", "smooth_on", "depth_norm", "automask_warmup",
             "color_jitter", "hflip", "aug_seed", "precision", "with_coverage")
    multi = make_multi_step(owner.state, 3, device=cuda,
                            **{k: getattr(owner.train_step, k) for k in names})
    batches = _graph_batches(9, seed=24)
    for r in range(3):
        chunk = batches[3 * r:3 * r + 3]
        for b in chunk:
            want = single.train_step(b)
        got = multi({k: np.stack([b[k] for b in chunk]) for k in chunk[0]})
        assert all(torch.equal(got[k], want[k]) for k in want), r
        a, b = _trainer_tensors(owner), _trainer_tensors(single)
        differ = [k for k in b if not torch.equal(a[k], b[k])]
        assert not differ, (r, differ[:5])
    graphs = multi.train_step.graphs
    assert len(graphs.graphs) == 1 and graphs.replays == 2
    assert owner.state.step == single.state.step == 9


def test_a_loaded_optimizer_state_drops_the_graphs(cuda, deterministic):
    # a checkpoint loaded into the optimizer replaces the tensors the graph
    # read: the next step runs eagerly, the one after captures anew, and
    # the steps equal an eager trainer's from the same loaded state
    captured, eager = _graph_trainer(cuda, None), _graph_trainer(cuda, False)
    batches = _graph_batches(6, seed=25)
    for b in batches[:3]:
        captured.train_step(b)
        eager.train_step(b)
    saved = eager.state.optimizer.state_dict()
    for trainer in (captured, eager):
        # a copy each: load_state_dict keeps the given tensors where it can
        trainer.state.optimizer.load_state_dict(copy.deepcopy(saved))
    for b in batches[3:]:
        got, want = captured.train_step(b), eager.train_step(b)
        assert torch.equal(got["loss"], want["loss"])
    # replays: 2 before the load (steps 2 and 3), 2 after (steps 5 and 6)
    graphs = captured.train_step.graphs
    assert len(graphs.graphs) == 1 and graphs.replays == 4


# --------------------------------------------------------------------------
# serving as one program: DepthToPointCloudPipeline and the pose-only eval
# step as CUDA graphs
# --------------------------------------------------------------------------


def _serve_pipelines(cuda, tmp_path, precision):
    """A seeded DispResNet-18 and two pipelines serving it at 64x96: the
    captured one (the default on the card) and an eager one."""
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_fn
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
        DepthToPointCloudPipeline,
    )
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR

    depth = build_model("DispResNet", torch.Generator().manual_seed(2), device=cuda)
    calib = _small_calib(tmp_path / "calib")

    def pipeline(graph):
        return DepthToPointCloudPipeline(make_depth_fn(depth, precision=precision),
                                         PseudoLiDAR(calib, device=cuda), device=cuda,
                                         graph=graph)

    return depth, pipeline(None), pipeline(False)


def _serve(pipeline, frames, index):
    """process() of one frame, process_batch() of a rig's frames."""
    if len(frames) == 1:
        return [pipeline.process(frames[0], index)]
    return pipeline.process_batch(frames, index)


@pytest.mark.parametrize("streams,precision", [(1, "fp32"), (2, "fp32"), (1, "bf16")],
                         ids=["batch1", "rig2", "batch1_bf16"])
def test_captured_pipeline_matches_the_eager_one(cuda, deterministic, tmp_path, streams,
                                                 precision):
    # 4 frames (or rig steps) of one batch shape: the first eager, the
    # second captures, the others replay; depth and clouds equal the eager
    # pipeline's bit for bit, one graph launch a call once captured, and no
    # kernel of ops/cuda on the serving path
    _, captured, eager = _serve_pipelines(cuda, tmp_path, precision)
    assert captured.graphs is not None and eager.graphs is None
    frames = np.random.default_rng(streams).normal(
        size=(4, streams, 64, 96, 3)).astype(np.float32)
    kernels.reset_launch_counts()
    for i, rig in enumerate(frames):
        replays = captured.graphs.replays
        got, want = _serve(captured, rig, i), _serve(eager, rig, i)
        assert captured.graphs.replays == replays + (i > 0)
        for a, b in zip(got, want):
            assert (a.frame_index, a.stream_index) == (b.frame_index, b.stream_index)
            assert np.array_equal(a.depth, b.depth)
            assert a.points.shape == b.points.shape and np.array_equal(a.points, b.points)
            assert a.points.shape[0] > 0
    assert len(captured.graphs.graphs) == 1 and captured.graphs.replays == 3
    assert kernels.launch_counts == dict.fromkeys(kernels.KERNELS, 0)


def test_captured_pipeline_serves_weights_loaded_in_place(cuda, deterministic, tmp_path):
    # weights copied into the live parameters after the capture are what
    # the next replay serves; a replaced parameter makes the next call
    # raise until reset(), which captures anew
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model

    depth, captured, eager = _serve_pipelines(cuda, tmp_path, "fp32")
    frames = np.random.default_rng(7).normal(size=(3, 64, 96, 3)).astype(np.float32)
    for i in range(2):
        captured.process(frames[i], i)
    other = build_model("DispResNet", torch.Generator().manual_seed(3), device=cuda)
    depth.load_state_dict(other.state_dict())
    replays = captured.graphs.replays
    got, want = captured.process(frames[2], 2), eager.process(frames[2], 2)
    assert captured.graphs.replays == replays + 1
    assert np.array_equal(got.depth, want.depth) and np.array_equal(got.points, want.points)
    depth.load_state_dict(build_model("DispResNet", torch.Generator().manual_seed(2),
                                      device=cuda).state_dict())
    assert not np.array_equal(captured.process(frames[2]).depth, got.depth)
    conv = next(m for m in depth.modules() if isinstance(m, torch.nn.Conv2d))
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    with pytest.raises(RuntimeError, match="replaced or moved"):
        captured.process(frames[0])
    captured.reset()
    for i in range(3):
        got, want = captured.process(frames[i], i), eager.process(frames[i], i)
        assert np.array_equal(got.depth, want.depth)
    assert len(captured.graphs.graphs) == 1


def test_captured_pose_eval_step_matches_the_eager_one(cuda, deterministic):
    # the pose-only step's body (normalize, PoseNet, pose_errors) captured
    # against the eager step over 4 host batches: every metric bit for bit,
    # the returned metrics not overwritten by a later replay
    from unsupervised_pseuso_lidar_tpu_torch.eval.pose import make_pose_eval_step
    from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model

    pose = build_model("PoseNet", torch.Generator().manual_seed(4), device=cuda)
    captured = make_pose_eval_step(pose, device=cuda)
    eager = make_pose_eval_step(pose, device=cuda, graph=False)
    assert captured.graphs is not None and eager.graphs is None
    rng = np.random.default_rng(8)
    kept = []
    for batch in _graph_batches(4, seed=26):
        batch["oxts"] = (rng.normal(size=(4, 2, 6)) * np.array([0.005] * 3 + [0.03] * 3)
                         ).astype(np.float32)
        got, want = captured(batch), eager(batch)
        assert sorted(got) == sorted(want) == ["ate", "ate_unscaled", "rot_err_deg", "scale"]
        assert all(torch.equal(got[k], want[k]) for k in want)
        kept.append((got, {k: v.clone() for k, v in got.items()}))
    assert all(torch.equal(got[k], values[k]) for got, values in kept for k in values)
    assert len(captured.graphs.graphs) == 1 and captured.graphs.replays == 3


@pytest.mark.parametrize("coarse, size", [((48, 160), (384, 1280)), ((24, 80), (384, 1280)),
                                           ((13, 152), (100, 1216)), ((10, 6), (7, 33))],
                         ids=["x8", "x16", "non_integer", "down"])
def test_resize_bilinear_gradient_repeats_and_is_the_cpu_s(cuda, coarse, size):
    # ops/resample._ResizeBilinear: its gathers and fixed tree of adds give
    # the same bits in every run and on the CPU; the forward is
    # F.interpolate's on either device
    gen = torch.Generator().manual_seed(41)
    x = torch.rand(2, 1, *coarse, generator=gen) + 0.5
    g = torch.randn(2, 1, *size, generator=gen)

    def grad(device):
        leaf = x.to(device).requires_grad_()
        out = resize_bilinear(leaf, *size)
        want = F.interpolate(leaf.detach(), size=size, mode="bilinear", align_corners=False)
        assert torch.equal(out.detach(), want)
        return torch.autograd.grad(out, leaf, g.to(device))[0]

    first = grad(cuda)
    assert torch.equal(grad(cuda), first)
    assert torch.equal(first.cpu(), grad("cpu"))
