"""Port parity for DispResNet with all_scales under the "spatial" mesh.

A coarse scale's disparity reaches the loss through a bilinear upsample
to the image's size, which reads across the band's edges. On a band the
port takes one coarse row of halo above and below, upsamples the slab by
the integer factor 2^s and crops 2^s rows at each inner edge
(losses/reprojection._full_res_depth): an integer-factor upsample is
shift-equivariant, so the band's rows are the whole map's. Each scale's
smoothness term, normalize_depth and the automask run on coarse bands of
the 32-row grain's counts (96 rows over 2 ranks: 64 / 32, at scale 3
8 / 4). Held here: the upsample on bands against the whole map (values and
gradients, scales 1-3), the four-scale objective on bands against the
whole, and one whole step of DispResNet-18 and of DispResNet-50
(bottleneck blocks on bands) with all_scales against the port's
one-process step (DispResNet-50's gradient against that step under a
one-rank mesh: its step is chaotic, see its test) and JAX's loss on the
whole batch; the depth nets bind_spatial takes (DispResNet, DispNetS,
StnDispNet, BtsModel: tests/test_torch_spatial_bts.py trains it).

The ranks are tests/torch_spatial_uneven_worker.py's, spawned on the CPU
by torch_parallel_worker.start_ranks.
"""

import numpy as np
import pytest
import torch

from tests import torch_parallel_worker as worker
from tests import torch_spatial_uneven_worker as uneven
from tests.test_torch_spatial import (
    STATS_RTOL,
    STEP_METRIC_RTOL,
    UNIT_RTOL,
    _flat,
    _rel_l2,
)
from tests.test_torch_spatial_uneven import (
    jax_loss,
    jax_nets,
    port_weights,
    test_step_on_uneven_bands_matches_the_jax_loss as _jax_loss_check,
    test_step_on_uneven_bands_matches_the_one_process_step as _one_process_check,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.reprojection import _full_res_depth
from unsupervised_pseuso_lidar_tpu_torch.models.layers import Banded
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import bind_spatial

torch.set_num_threads(1)
NAMES = ("all_scales_18", "all_scales_50")
SPATIAL = 2
# one rounding of an fp32 value, relative to it (2 ulp at most)
ONE_ROUNDING = 2.0 ** -22


def _inputs():
    """The upsample unit's coarse maps and cotangents (scales 1-3 of a 96 x
    64 image) and the four-scale loss unit's frames, poses and
    disparities (96 x 64, batch 2)."""
    gen = torch.Generator().manual_seed(8)
    height, width = uneven.UPSAMPLE_SHAPE
    upsample = {s: (torch.rand(2, 1, height >> s, width >> s, generator=gen) * 5 + 1,
                    torch.randn(2, height, width, generator=gen)) for s in (1, 2, 3)}
    frames = (torch.rand(2, 3, height, width, generator=gen),
              [torch.rand(2, 3, height, width, generator=gen) for _ in range(2)],
              torch.randn(2, 2, 6, generator=gen) * torch.tensor([0.01] * 3 + [0.05] * 3),
              torch.tensor([[40.0, 0.0, 31.5], [0.0, 40.0, 47.5], [0.0, 0.0, 1.0]]))
    disps = [[torch.rand(2, 1, height >> s, width >> s, generator=gen) * 0.8 + 0.05
              for s in range(4)] for _ in range(2)]
    return upsample, (*frames, disps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": every rank's results, "ref": the one-process steps,
    "jax": JAX's losses, "inputs": the units' inputs}."""
    nets = jax_nets()
    weights = port_weights(nets)
    upsample, loss_inputs = _inputs()
    wait = worker.start_ranks(uneven.scale_ranks, SPATIAL, tmp_path_factory.mktemp("scales"),
                              weights, NAMES, upsample, loss_inputs, spatial=SPATIAL)
    wait_data = worker.start_ranks(uneven.data_mesh_steps, 1,
                                   tmp_path_factory.mktemp("scales_data"), weights,
                                   ("all_scales_50",))
    ref = {name: uneven.one_step(weights, name) for name in NAMES}
    losses = {name: jax_loss(nets, name) for name in NAMES}
    return {"ranks": wait(), "ref": ref, "data_mesh": wait_data()[0], "jax": losses,
            "inputs": (upsample, loss_inputs)}


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_full_res_depth_on_a_band_is_the_band_of_the_whole_upsample(runs, scale):
    # a scale-s map's upsample on each band (a coarse halo row each side,
    # factor 2^s, cropped) is the band's rows of the whole map's upsample:
    # the same taps and weights, so within one rounding of each value
    # (F.interpolate's CPU kernel rounds by an output's place in memory:
    # the first band's rows are bit for bit the whole map's, the second's
    # differ by 1 ulp in places); the gradient of sum(out · g) w.r.t. the
    # coarse map, the bands' concatenated, at rel L2 <= UNIT_RTOL (the
    # halo rows' gradients come back to their owner and add after its own)
    coarse, g = runs["inputs"][0][scale]
    leaf = coarse.clone().requires_grad_()
    whole = _full_res_depth(leaf, *uneven.UPSAMPLE_SHAPE)
    (whole * g).sum().backward()
    parts = [r["upsample"][scale] for r in runs["ranks"]]
    got = torch.cat([p[0] for p in parts], dim=1)
    assert got.shape == whole.shape
    assert torch.equal(parts[0][0], whole[:, :parts[0][0].shape[1]].detach())
    assert bool(((got - whole.detach()).abs() <= ONE_ROUNDING * whole.detach().abs()).all())
    assert _rel_l2(torch.cat([p[1] for p in parts], dim=2), leaf.grad) <= UNIT_RTOL


def test_four_scale_loss_on_bands_matches_the_whole(runs):
    # total_loss ('min', depth_norm, smoothness on the depth at 0.01) of
    # four disparity scales, each rank on its band of every scale: the
    # mean over the ranks of the loss and of automask_keep is the whole
    # input's; each disparity's gradient, the bands' concatenated and
    # divided by the ranks (each rank's loss is spatial × its share), and
    # the pose gradient's mean over the ranks, at rel L2 <= UNIT_RTOL
    tgt, refs, poses, intrinsics, disps = runs["inputs"][1]
    ref = uneven.multiscale_loss((tgt, refs, poses, intrinsics, disps))
    ranks = [r["loss"] for r in runs["ranks"]]
    for i in (0, 1):
        assert _rel_l2(sum(r[i] for r in ranks) / SPATIAL, ref[i]) <= UNIT_RTOL, i
    for frame in (0, 1):
        for scale in range(4):
            got = torch.cat([r[2][frame][scale] for r in ranks], dim=2) / SPATIAL
            assert _rel_l2(got, ref[2][frame][scale]) <= UNIT_RTOL, (frame, scale)
    assert _rel_l2(sum(r[3] for r in ranks) / SPATIAL, ref[3]) <= UNIT_RTOL


def test_all_scales_step_matches_the_one_process_step(runs):
    # DispResNet-18 with all_scales, as test_torch_spatial_uneven's: ranks
    # bit for bit alike, metrics rel 1e-5, gradient rel L2 1e-4, BatchNorm
    # statistics 1e-5
    name = "all_scales_18"
    _one_process_check({"ranks": {name: [r["steps"][name] for r in runs["ranks"]]},
                        "ref": runs["ref"]}, name)


def test_all_scales_50_step_matches_the_one_process_step_under_a_one_rank_mesh(runs):
    # DispResNet-50 with all_scales: the same bounds against its step on
    # the whole batch under a data mesh of one rank, whose BatchNorm sums
    # as the bands' does (layers._GlobalBatchNorm); against the plain
    # one-process step (F.batch_norm) the metrics at rel 1e-5 and the
    # statistics at 1e-5. Its gradient is chaotic: weights moved by 1e-7
    # relative move it by 9e-3 – 2e-2 rel L2 at batch seeds 1-2, and the
    # one-rank mesh's sits 7.3e-3 from the plain step's, as the bands' does
    # (ROADMAP.md §3)
    name = "all_scales_50"
    ranks = [r["steps"][name] for r in runs["ranks"]]
    _one_process_check({"ranks": {name: ranks}, "ref": {name: runs["data_mesh"][name]}}, name)
    plain = runs["ref"][name]
    for key, value in plain["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][key], value, rtol=STEP_METRIC_RTOL,
                                   err_msg=key)
    for key, value in plain["stats"].items():
        np.testing.assert_allclose(ranks[0]["stats"][key].numpy(), value.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_RTOL, err_msg=key)
    print("all_scales_50 vs the plain step: gradient rel L2 "
          f"{_rel_l2(_flat(ranks[0]['grads']), _flat(plain['grads'])):.3g} (bands), "
          f"{_rel_l2(_flat(runs['data_mesh'][name]['grads']), _flat(plain['grads'])):.3g} "
          "(one-rank mesh)")


@pytest.mark.parametrize("name", NAMES)
def test_all_scales_step_matches_the_jax_loss(runs, name):
    _jax_loss_check({"ranks": {name: [r["steps"][name] for r in runs["ranks"]]},
                     "jax": runs["jax"]}, name)


@pytest.mark.parametrize("kwargs", [{"num_layers": n, "all_scales": a}
                                    for n in (18, 34, 50, 101, 152) for a in (False, True)])
def test_bind_spatial_takes_dispresnet_at_every_depth_and_scale_set(kwargs):
    mesh = Mesh(None, 0, SPATIAL, torch.device("cpu"), spatial=SPATIAL)
    model = build_model("DispResNet", device="cpu", **kwargs)
    bind_spatial([model, build_model("PoseNet", device="cpu")], mesh)
    assert model.encoder.encoder.conv1.mesh is mesh


@pytest.mark.parametrize("name,kwargs", [
    ("DispNetS", {}), ("StnDispNet", {"image_shape": (64, 96)}),
    ("StnDispNet", {"use_stn": True, "image_shape": (64, 96)}),
    ("BtsModel", {"num_features": 128})])
def test_bind_spatial_takes_dispnets_and_stn_dispnet(name, kwargs):
    # every banded module of the net (its convs, pools, transposed convs
    # and GroupNorms, and the net itself) is bound to the mesh, and
    # unbound without it
    mesh = Mesh(None, 0, SPATIAL, torch.device("cpu"), spatial=SPATIAL)
    model = build_model(name, device="cpu", **kwargs)
    bind_spatial([model, build_model("PoseFc", device="cpu", image_shape=(64, 96))], mesh)
    banded = [m for m in model.modules() if isinstance(m, Banded)]
    assert model in banded and len(banded) > 20
    assert all(m.mesh is mesh for m in banded)
    bind_spatial([model], None)
    assert all(m.mesh is None for m in banded)

