"""Port parity for the "spatial" mesh axis (image rows sharded over ranks).

Under JAX's ("data", "spatial") mesh GSPMD runs the single-device program
over the GLOBAL batch, partitioning the convolutions with halo exchange.
The port runs one process a rank, each on its images' band of rows, and
must give the same result: the placement of rows on ranks (JAX's
shard_batch), the units that read across a band's edge (the halo
convolutions and max-pool, the SSIM slab with kernel B's and C's plain
versions, the smoothness term, normalize_depth, the 'min' loss), kernel
A's plain version on a band of grid rows, and whole steps at spatial 2
(world 2) and at data 2 x spatial 2 (world 4) against the port's
one-process step and JAX's step on the whole batch.

The ranks are gloo process groups spawned on the CPU
(tests/torch_spatial_worker.py via torch_parallel_worker.run_ranks, one
thread each); each group computes every case, whose tests then read its
results.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_parallel_worker as worker
from tests import torch_spatial_worker as spatial_worker
from tests.test_torch_train import _jax_step, jax_models  # noqa: F401
from unsupervised_pseuso_lidar_tpu.data import augment as jax_augment
from unsupervised_pseuso_lidar_tpu.parallel import mesh as jax_mesh
from unsupervised_pseuso_lidar_tpu_torch.data import augment as port_augment
from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import pose_matrix
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    in_frame_fraction,
    warp_coords,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import photometric_loss
from unsupervised_pseuso_lidar_tpu_torch.losses.smoothness import smooth_loss
from unsupervised_pseuso_lidar_tpu_torch.losses.total import normalize_depth, total_loss
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh, shard_batch
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
SPATIAL = 2
# a unit on the bands vs the same function on the whole input (rel L2 of
# the values and of the gradients): the bands' convolutions run on other
# shapes than the whole map's, so their sums may round differently
UNIT_RTOL = 1e-5
# the sharded step vs the port's one-process step: the gradient (every
# parameter's, concatenated) at rel L2, the metrics, BatchNorm statistics
# (tests/test_torch_parallel.py's tolerances), and the parameters after
# MULTI_STEPS steps at JAX's test_multi_step_mesh tolerance (Adam's first
# updates are ±lr wherever a gradient is not 0: a gradient near 0 that
# changes sign moves its parameter by 2·lr)
STEP_GRAD_REL_L2 = 1e-4
STEP_METRIC_RTOL = 1e-5
STATS_RTOL = 1e-5
PARAMS_RTOL, PARAMS_ATOL = 1e-3, 2e-4
# the sharded step's loss vs the JAX step on the full batch: JAX's own
# sharded-vs-single-device tolerance (tests/test_train.py)
JAX_LOSS_RTOL = 2e-4
# a step's whole gradient vs JAX's (tests/test_torch_train.py holds every
# key of it at 1e-3)
JAX_GRAD_REL_L2 = 1e-3


def _rel_l2(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_shard_batch_takes_the_rows_and_bands_jax_places_on_each_device(accum_steps):
    # make_mesh(4, spatial=2): rank r at data index r // 2, spatial index
    # r % 2, as JAX's devices.reshape(2, 2); each rank's tgt, ref_imgs,
    # groundtruth and intrinsics are the addressable shard of JAX's
    # shard_batch on that device (accum_steps 2: of the reshaped
    # [2, B/2, ...] batch, as the step's micro-batches place it)
    rng = np.random.default_rng(0)
    batch = {"tgt": rng.uniform(size=(8, 4, 6, 3)).astype(np.float32),
             "ref_imgs": rng.uniform(size=(8, 2, 4, 6, 3)).astype(np.float32),
             "groundtruth": rng.uniform(size=(8, 4, 6)).astype(np.float32),
             "intrinsics": rng.uniform(size=(8, 3, 3)).astype(np.float32)}
    mesh = jax_mesh.make_mesh(4, spatial=SPATIAL)
    if accum_steps == 1:
        placed = jax_mesh.shard_batch(mesh, batch)
    else:
        specs = {"tgt": P(None, "data", "spatial"), "ref_imgs": P(None, "data", None, "spatial"),
                 "groundtruth": P(None, "data", "spatial"), "intrinsics": P(None, "data")}
        placed = {k: jax.device_put(v.reshape(2, 4, *v.shape[1:]),
                                    NamedSharding(mesh, specs[k]))
                  for k, v in batch.items()}
    for rank, device in enumerate(mesh.devices.reshape(-1)):
        ours = Mesh(None, rank, 4, torch.device("cpu"), spatial=SPATIAL)
        assert (ours.data_rank, ours.spatial_rank) == tuple(
            int(i) for i in np.argwhere(mesh.devices == device)[0])
        assert ours.shape == dict(mesh.shape)
        got = shard_batch(ours, batch, accum_steps=accum_steps)
        for key in batch:
            shard = next(s for s in placed[key].addressable_shards if s.device == device)
            want = np.asarray(shard.data)
            want = want.reshape(-1, *want.shape[2:]) if accum_steps == 2 else want
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    with pytest.raises(ValueError, match="does not split into 2 bands"):
        shard_batch(Mesh(None, 0, 4, torch.device("cpu"), spatial=SPATIAL),
                    {"tgt": batch["tgt"][:, :3]})


@pytest.mark.parametrize("height,spatial,rows", [
    (96, 2, [64, 32]), (80, 2, [64, 16]), (160, 4, [64, 32, 32, 32]),
    (192, 4, [64, 64, 32, 32]), (384, 8, [64] * 4 + [32] * 4), (384, 3, [128] * 3),
    (192, 3, [64] * 3), (256, 2, [128, 128]), (100, 4, [32, 32, 32, 4])])
def test_shard_batch_bands_fall_on_the_32_row_grain(height, spatial, rows):
    # at an uneven height JAX places H/s rows a device; the port's bands
    # split the ceil(H/32) rows of 32 as evenly as possible, the larger
    # parts first (only the last band may end off the grain), so that
    # every level of DispResNet keeps an integer band edge: each rank's
    # tgt and groundtruth are its band of JAX's global array, and the
    # bands cover it in order. Where H is a multiple of 32·s the bands are
    # JAX's own (256 at spatial 2)
    rng = np.random.default_rng(1)
    batch = {"tgt": rng.uniform(size=(2, height, 5, 3)).astype(np.float32),
             "groundtruth": rng.uniform(size=(2, height, 5)).astype(np.float32)}
    got, start = [], 0
    for rank in range(spatial):
        placed = shard_batch(Mesh(None, rank, spatial, torch.device("cpu"), spatial=spatial),
                             batch)
        assert placed["tgt"].shape[1] == placed["groundtruth"].shape[1] == rows[rank]
        np.testing.assert_array_equal(placed["tgt"], batch["tgt"][:, start:start + rows[rank]])
        start += rows[rank]
        got.append(placed["groundtruth"])
    np.testing.assert_array_equal(np.concatenate(got, axis=1), batch["groundtruth"])
    assert all(edge % 32 == 0 for edge in np.cumsum(rows)[:-1])
    if height % (32 * spatial) == 0:
        mesh = jax_mesh.make_mesh(spatial, spatial=spatial)
        shards = jax_mesh.shard_batch(mesh, batch)["tgt"].addressable_shards
        assert sorted(s.data.shape[1] for s in shards) == rows
    with pytest.raises(ValueError, match="not divisible by spatial=3"):
        Mesh(None, 0, 4, torch.device("cpu"), spatial=3)


# --------------------------------------------------------------------------
# the units, and the layout of a 2 x 2 mesh
# --------------------------------------------------------------------------

UNIT_LAYERS = {
    # name -> (layer, input [N, C, H, W]): a 3x3 conv at stride 1 and 2, the
    # 7x7 stride-2 stem, the stem's max-pool, the decoder's reflect-padded
    # Conv3x3, and that Conv3x3 on a 2-row map (one row a band: the
    # reflection at the image's top reads the row of the band below)
    "conv3x3_s1": (("conv", 3, 1, 1), (2, 4, 16, 12)),
    "conv3x3_s2": (("conv", 3, 2, 1), (2, 4, 16, 12)),
    "conv7x7_s2": (("conv", 7, 2, 3), (2, 4, 16, 12)),
    "maxpool": (("maxpool",), (2, 4, 16, 12)),
    "conv3x3_reflect": (("conv3x3",), (2, 4, 16, 12)),
    "conv3x3_reflect_one_row": (("conv3x3",), (2, 4, 2, 5)),
}


def _unit_inputs():
    gen = torch.Generator().manual_seed(7)
    unit_layers = []
    for name, (kind, shape) in UNIT_LAYERS.items():
        x = torch.randn(shape, generator=gen)
        out, _, _ = spatial_worker.run_layer(kind, x, torch.zeros(1))
        unit_layers.append((name, kind, x, torch.randn(out.shape, generator=gen)))
    pred = torch.rand(2, 3, 16, 12, generator=gen)
    # the target equal to pred in places: flat windows and ties occur
    target = torch.where(torch.rand(2, 3, 16, 12, generator=gen) < 0.3, pred,
                         torch.rand(2, 3, 16, 12, generator=gen))
    frames = (torch.rand(2, 3, 16, 12, generator=gen),
              [torch.rand(2, 3, 16, 12, generator=gen) for _ in range(2)],
              torch.randn(2, 2, 6, generator=gen) * torch.tensor([0.01] * 3 + [0.05] * 3),
              torch.tensor([[10.0, 0.0, 5.5], [0.0, 10.0, 7.5], [0.0, 0.0, 1.0]]).expand(2, 3, 3))
    return {"layers": unit_layers,
            "ssim": (pred, target, torch.randn(2, 3, 16, 12, generator=gen)),
            "disp": torch.rand(2, 1, 16, 12, generator=gen) * 0.8 + 0.05,
            "disp_ref0": torch.rand(2, 1, 16, 12, generator=gen) * 0.8 + 0.05,
            "g_disp": torch.randn(2, 1, 16, 12, generator=gen),
            "frames": frames}


def _small_config(tmp_path, name):
    # test_config.yaml at 64x96, batch 4, checkpoints under tmp_path/name
    with open(os.path.join(worker.REPO, "configs", "test_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["datasets"]["augmentation"].update(image_height=worker.HEIGHT,
                                           image_width=worker.WIDTH)
    raw["action"].update(batch_size=worker.BATCH, num_epochs=1, log_freq=1,
                         checkpoint_dir=str(tmp_path / name))
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return config_module.load_config(str(path))


@pytest.fixture(scope="module")
def weights(jax_models):  # noqa: F811
    """test_torch_train's JAX weights (DispResNet-18, PoseNet with the
    pose-head bias) and a seeded PoseFc at 64x96 whose last layer has a
    seeded translation bias (its zero-initialized last layer would make
    the warp the identity, every sample on a pixel, where the bilinear
    gradient jumps)."""
    _, _, params, stats = jax_models
    pose_fc = build_model("PoseFc", torch.Generator().manual_seed(3), "cpu",
                          image_shape=(worker.HEIGHT, worker.WIDTH))
    with torch.no_grad():
        pose_fc.fc_loc[-1].bias.copy_(
            torch.randn(12, generator=torch.Generator().manual_seed(4)) * 0.03)
    return {"depth": state_dict_from_jax(params["depth"], stats, "DispResNet"),
            "PoseNet": state_dict_from_jax(params["pose"], {}, "PoseNet"),
            "PoseFc": pose_fc.state_dict()}


@pytest.fixture(scope="module")
def runs(jax_models, weights, tmp_path_factory):  # noqa: F811
    """{"2": every rank of the spatial-2 mesh, "2x2": of the data 2 x
    spatial 2 mesh, "ref": the one-process results, "jax_loss": the JAX
    step's 'min' loss on the whole batch}, the one-process and JAX steps
    computed while the ranks run."""
    inputs = _unit_inputs()
    tmp = tmp_path_factory.mktemp("spatial")
    wait_2 = worker.start_ranks(spatial_worker.row_of_two, SPATIAL, tmp, inputs, weights,
                                _small_config(tmp, "2"), spatial=SPATIAL)
    wait_4 = worker.start_ranks(spatial_worker.two_by_two, 2 * SPATIAL, tmp, weights,
                                _small_config(tmp, "2x2"), spatial=SPATIAL)
    ref = {name: spatial_worker.one_step(weights, name)
           for name in (*spatial_worker.STEP_CASES, *spatial_worker.JAX_GRADIENT_CASES)}
    ref["multi"] = spatial_worker.multi_steps(weights)
    ref["eval"] = spatial_worker.eval_step(weights)
    _, jax_metrics = _jax_step(jax_models, spatial_worker.step_batch("min"), accum_steps=1)
    return {"2": wait_2(), "2x2": wait_4(), "ref": ref, "inputs": inputs,
            "jax_loss": float(jax_metrics["loss"]), "jax_grads": _jax_gradients(jax_models)}


def _port_draws_augment(step, batch, jitter=True, flip=False, seed=0):
    """JAX's augment_batch with the port's draws (data/augment.draw_params
    of (seed, 0): the step is the first), applied with JAX's ops in its
    order — flip (frames, cx, ground truth), then jitter — so that JAX's
    step sees the batch the port's steps see."""
    params = port_augment.draw_params(batch["tgt"].shape[0], seed, 0)
    flips = jnp.asarray(params.flip.numpy())
    add = jnp.asarray(params.add.numpy())[:, None, None, None]
    scale = jnp.asarray(params.scale.numpy())[:, None, None, None]
    tgt, refs, intrinsics = batch["tgt"], batch["ref_imgs"], batch["intrinsics"]
    out = dict(batch)
    if flip:
        width = tgt.shape[2]
        tgt = jnp.where(flips[:, None, None, None], tgt[:, :, ::-1], tgt)
        refs = jnp.where(flips[:, None, None, None, None], refs[:, :, :, ::-1], refs)
        cx = jnp.where(flips, (width - 1) - intrinsics[:, 0, 2], intrinsics[:, 0, 2])
        intrinsics = intrinsics.at[:, 0, 2].set(cx)
        if "groundtruth" in batch:
            out["groundtruth"] = jnp.where(flips[:, None, None],
                                           batch["groundtruth"][:, :, ::-1],
                                           batch["groundtruth"])
    if jitter:
        tgt, refs = tgt * scale + add, refs * scale[:, None] + add[:, None]
    return dict(out, tgt=tgt, ref_imgs=refs, intrinsics=intrinsics)


def _jax_gradients(jax_models):  # noqa: F811
    """{case: the JAX step's gradient on the global batch, by the port's
    parameter names} of JAX_GRADIENT_CASES, with the port's augmentation
    draws (_port_draws_augment)."""
    out = {}
    saved = jax_augment.augment_batch
    jax_augment.augment_batch = _port_draws_augment
    try:
        for name, (_, _, kwargs) in spatial_worker.JAX_GRADIENT_CASES.items():
            settings = {k: v for k, v in kwargs.items() if k != "loss_mode"}
            state, _ = _jax_step(jax_models, spatial_worker.step_batch(name), accum_steps=1,
                                 **settings)
            grads = jax.tree.map(np.asarray, state.opt_state)
            out[name] = {f"{net}.{k}": torch.as_tensor(np.asarray(v))
                         for net, kind in (("depth", "DispResNet"), ("pose", "PoseNet"))
                         for k, v in state_dict_from_jax(grads[net], None, kind).items()}
    finally:
        jax_augment.augment_batch = saved
    return out


def _one_process_units(inputs):
    out = {}
    for name, kind, x, g in inputs["layers"]:
        out[name] = spatial_worker.run_layer(kind, x, g)
    pred, target, g = inputs["ssim"]
    p, t = pred.clone().requires_grad_(), target.clone().requires_grad_()
    m = photometric_loss(p, t, clip_loss=0.0)
    (m * g).sum().backward()
    out["ssim"] = (m.detach(), p.grad, t.grad)
    out["ssim_clip"] = photometric_loss(pred, target)
    d = inputs["disp"].clone().requires_grad_()
    value = smooth_loss([d])
    value.backward()
    out["smooth"] = (value.detach(), d.grad)
    d = inputs["disp"].clone().requires_grad_()
    normalized = normalize_depth(d)
    (normalized * inputs["g_disp"]).sum().backward()
    out["normalize_depth"] = (normalized.detach(), d.grad)
    tgt, refs, poses, intrinsics = inputs["frames"]
    disps = [inputs["disp"].clone().requires_grad_(),
             inputs["disp_ref0"].clone().requires_grad_()]
    pose_leaf = poses.clone().requires_grad_()
    reproj, smooth, extra = total_loss(tgt, refs, [[disps[0]], [disps[1]]], pose_leaf,
                                       intrinsics, mode="min", smooth_on="disp",
                                       smooth_weight=0.001, depth_norm=True)
    (reproj + smooth).backward()
    out["min_loss"] = ((reproj + smooth).detach(), disps[0].grad, disps[1].grad,
                       pose_leaf.grad, extra["automask_keep"])
    return out


# how each unit's per-rank results combine into the whole input's:
# "rows" concatenates the bands, "sum" adds the ranks' parts, "mean"
# averages them (a rank's loss is its share; the step averages over ranks)
UNIT_COMBINE = {
    **{name: ("rows", "rows", "sum") for name in UNIT_LAYERS},
    "ssim": ("rows", "rows", "rows"),
    "smooth": ("mean", "rows_mean"),
    "normalize_depth": ("rows", "rows"),
    "min_loss": ("mean", "rows_mean", "rows_mean", "mean", "mean"),
}


@pytest.mark.parametrize("name", [*UNIT_LAYERS, "ssim", "smooth", "normalize_depth",
                                  "min_loss"])
def test_unit_on_bands_matches_the_whole_input(runs, name):
    # each function on the 2 bands (halos exchanged, the sums over the data
    # row) vs the same function on the whole input: the outputs and the
    # gradients of the inputs and weights at rel L2 <= UNIT_RTOL. Layers:
    # the loss sum(out · g); the stride-2 ones show that a band's outputs
    # are exactly the image's output rows of that band. ssim: the
    # 0.85 SSIM + 0.15 L1 map on slabs (kernel B's and C's plain versions;
    # pred and target both take a gradient). smooth, min_loss: a rank's
    # value is its share, the mean over the ranks the whole input's value
    ranks = [r["units"][name] for r in runs["2"]]
    ref = _one_process_units(runs["inputs"])[name]
    for i, combine in enumerate(UNIT_COMBINE[name]):
        parts = [r[i] for r in ranks]
        if ref[i] is None:
            assert all(p is None for p in parts)
            continue
        if combine == "rows":
            got = torch.cat(parts, dim=2)
        elif combine == "rows_mean":
            got = torch.cat(parts, dim=2) / len(parts)
        elif combine == "sum":
            got = parts[0] + parts[1]
        else:
            got = sum(parts) / len(parts)
        assert got.shape == ref[i].shape, (i, got.shape, ref[i].shape)
        rel = _rel_l2(got, ref[i])
        assert rel <= UNIT_RTOL, (name, i, rel)


def test_the_ssim_clip_threshold_is_the_whole_image_s(runs):
    # the 'ssim' objective's clamp at mean + 0.5 std of the map: the
    # ranks' bands of the clamped map equal the whole map's clamped rows
    got = torch.cat([r["units"]["ssim_clip"] for r in runs["2"]], dim=2)
    ref = _one_process_units(runs["inputs"])["ssim_clip"]
    assert _rel_l2(got, ref) <= UNIT_RTOL


def test_mesh_layout_groups_and_what_the_mesh_refuses(runs):
    # make_mesh(4, spatial=2): shape {data 2, spatial 2}, rank r at
    # (r // 2, r % 2), its data row's group the ranks {2·(r // 2), +1};
    # spatial 3 of 4 ranks, an odd split and BtsModel at 80 rows (no
    # multiple of 32) raise; a 32-row image (one row of 32 for two bands:
    # DispResNet's coarsest level runs on the gathered map) trains;
    # DispNetS, StnDispNet with its STN, DispResNet-18 and -50 with
    # all_scales and BtsModel bind
    bts = "bts_height_80"
    for rank, result in enumerate(r["layout"] for r in runs["2x2"]):
        assert result["shape"] == {"data": 2, "spatial": 2}
        assert (result["rank"], result["data_rank"], result["spatial_rank"]) == (
            rank, rank // 2, rank % 2)
        assert result["row_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        errors = result["errors"]
        assert "not divisible by spatial=3" in errors["spatial_3"]
        assert all(np.isfinite(v) for v in result["height_32"].values())
        assert result["height_32"] == runs["2x2"][0]["layout"]["height_32"]
        assert "does not split into 2 bands" in errors["height_33"]
        assert "80x96 image does not shard" in errors[bts] and "multiple of 32" in errors[bts]
        assert sorted(errors) == [bts, "height_33", "spatial_3"]


# --------------------------------------------------------------------------
# kernel A's plain version on a band of grid rows
# --------------------------------------------------------------------------


def test_warp_on_a_band_of_grid_rows_is_the_band_of_the_warp():
    # warp_coords of a band of the depth rows (row_start, the image's
    # height) are the band's rows of the whole coordinates, bit for bit;
    # kernel A's and A′'s plain versions (the CPU route of the wrappers)
    # on those grid rows over the whole image give the band's rows of the
    # whole warp and of its grid gradient; in_frame_fraction counts
    # samples against the source image's rows
    gen = torch.Generator().manual_seed(5)
    depth = torch.rand(3, 16, 12, generator=gen) * 5 + 1
    transform = pose_matrix((torch.randn(3, 6, generator=gen) * 0.05).double())
    k = torch.tensor([[10.0, 0.0, 5.5], [0.0, 10.0, 7.5], [0.0, 0.0, 1.0]])
    img = torch.rand(3, 3, 16, 12, generator=gen)
    g = torch.randn(3, 3, 16, 12, generator=gen)
    whole = warp_coords(depth, transform, k)
    out = kernels.warp_bilinear_fwd(img, whole)
    d_grid = kernels.warp_bilinear_bwd_grid(img, whole, g)
    for start, stop in ((0, 8), (8, 16), (4, 12)):
        coords = warp_coords(depth[:, start:stop], transform, k, row_start=start, height=16)
        assert torch.equal(coords, whole[:, start:stop])
        assert torch.equal(kernels.warp_bilinear_fwd(img, coords), out[:, :, start:stop])
        assert torch.equal(kernels.warp_bilinear_bwd_grid(img, coords, g[:, :, start:stop]),
                           d_grid[:, start:stop])
    bands = [in_frame_fraction(whole[:, r:r + 8], height=16) for r in (0, 8)]
    assert torch.allclose(sum(bands) / 2, in_frame_fraction(whole), rtol=1e-6)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------


def _flat(grads):
    return torch.cat([g.reshape(-1) for _, g in sorted(grads.items()) if g is not None])


@pytest.mark.parametrize("mesh_name", ["2", "2x2"])
@pytest.mark.parametrize("name", sorted(spatial_worker.STEP_CASES))
def test_step_matches_the_one_process_step(runs, mesh_name, name):
    # every rank returns the same metrics and gradients (bit for bit: the
    # other ranks' digest of theirs); against the port's step on the whole
    # batch in one process: the metrics at rel
    # 1e-5, the gradient at rel L2 <= 1e-4 (worst key printed), the
    # BatchNorm running statistics at 1e-5
    ranks = [r["steps"][name] for r in runs[mesh_name]]
    for other in ranks[1:]:
        assert other["metrics"] == ranks[0]["metrics"]
        assert other["grads"] == spatial_worker.digest(ranks[0]["grads"])
    got, ref = ranks[0], runs["ref"][name]
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for key, value in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=STEP_METRIC_RTOL,
                                   err_msg=key)
    assert [k for k, g in got["grads"].items() if g is None] == \
        [k for k, g in ref["grads"].items() if g is None]
    rel = _rel_l2(_flat(got["grads"]), _flat(ref["grads"]))
    worst = max((_rel_l2(g, ref["grads"][k]), k) for k, g in got["grads"].items()
                if g is not None and float(ref["grads"][k].abs().max()) > 0)
    print(f"{mesh_name} {name}: gradient rel L2 {rel:.3g}; worst key {worst[1]} at "
          f"{worst[0]:.3g}")
    assert rel <= STEP_GRAD_REL_L2, rel
    for key, value in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][key].numpy(), value.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_RTOL, err_msg=key)


@pytest.mark.parametrize("mesh_name", ["2", "2x2"])
def test_step_matches_the_jax_step_on_the_global_batch(runs, mesh_name):
    # 'min' at 64x96, batch 4 on bands of 32 rows: the ranks' loss vs
    # make_train_step_body on the whole batch on one device
    for rank in runs[mesh_name]:
        np.testing.assert_allclose(rank["steps"]["min"]["metrics"]["loss"], runs["jax_loss"],
                                   rtol=JAX_LOSS_RTOL)


@pytest.mark.parametrize("mesh_name", ["2", "2x2"])
def test_augment_at_batch_seed_3_against_the_jax_gradient(runs, mesh_name):
    # the 'augment' case at batch seed 3, where every mesh's gradient sits
    # 2.1e-4 rel L2 from the one-process step's: each side on its own
    # against JAX's step on the global batch (the port's augmentation
    # draws given to both). The one-process step lands 1.3e-5 from JAX,
    # every mesh 2.1e-4: the BatchNorm's normalization rounds otherwise
    # under a mesh (fp64 sums and (x − mean) · invstd · w + b) than
    # F.batch_norm does, and at this batch one ulp of it moves the
    # gradient across a pixel crossing. flax's fp32 rule on the mesh side
    # lands there too (ROADMAP.md §3). Both sides are held to JAX at
    # test_torch_train's gradient bound, and the ranks agree bit for bit
    name = "augment_seed_3"
    ref = runs["jax_grads"][name]
    ranks = [r["steps"][name] for r in runs[mesh_name]]
    assert all(r["grads"] == spatial_worker.digest(ranks[0]["grads"]) for r in ranks[1:])
    for side, grads in (("one process", runs["ref"][name]["grads"]),
                        ("mesh", ranks[0]["grads"])):
        keys = {k for k, g in grads.items() if g is not None}
        # JAX's gradient holds zeros for the heads the loss does not read
        assert keys <= set(ref) and all(not ref[k].any() for k in set(ref) - keys)
        rel = _rel_l2(_flat(grads), _flat({k: ref[k] for k in keys}))
        print(f"{mesh_name} {side} vs JAX: gradient rel L2 {rel:.3g}")
        assert rel <= JAX_GRAD_REL_L2, (side, rel)


@pytest.mark.parametrize("mesh_name", ["2", "2x2"])
def test_multi_step_parameters_match_the_one_process_steps(runs, mesh_name):
    # make_multi_step(num_steps=3, mesh=) vs make_multi_step in one process:
    # the same parameters on every rank, within PARAMS_RTOL / PARAMS_ATOL
    # of the one-process ones; the last metrics at rel 1e-5
    ranks = [r["steps"]["multi"] for r in runs[mesh_name]]
    ref_params, ref_metrics = runs["ref"]["multi"]
    for params, metrics in ranks:
        assert params is ranks[0][0] or params == spatial_worker.digest(ranks[0][0])
        for key, value in ref_metrics.items():
            np.testing.assert_allclose(metrics[key], value, rtol=STEP_METRIC_RTOL,
                                       err_msg=key)
    for key, value in ref_params.items():
        torch.testing.assert_close(ranks[0][0][key], value, rtol=PARAMS_RTOL,
                                   atol=PARAMS_ATOL, msg=key)


@pytest.mark.parametrize("mesh_name", ["2", "2x2"])
def test_eval_step_metrics_and_depth_are_the_whole_images(runs, mesh_name):
    # EvalStep under the mesh ('ssim' loss, Eigen protocol, pose metrics):
    # every metric at rel 1e-5 of one process on the whole batch, the same
    # on every rank; depth_pred holds the rank's images, whole
    ref_metrics, ref_depth = runs["ref"]["eval"]
    data = 1 if mesh_name == "2" else 2
    for rank, (metrics, depth) in enumerate(r["steps"]["eval"] for r in runs[mesh_name]):
        assert sorted(metrics) == sorted(ref_metrics)
        for key, value in ref_metrics.items():
            np.testing.assert_allclose(metrics[key], value, rtol=STEP_METRIC_RTOL,
                                       err_msg=key)
        rows = slice(rank // SPATIAL * (4 // data), (rank // SPATIAL + 1) * (4 // data))
        assert _rel_l2(depth, ref_depth[rows]) <= STEP_METRIC_RTOL


@pytest.mark.parametrize("mesh_name", ["2", "2x2"])
def test_trainer_fits_and_validates_under_the_mesh(runs, mesh_name):
    # Trainer(mesh=).fit over one epoch of 2 batches with validation, rank
    # 0 logging to a wandb stub: every rank at step 2 with the same
    # metrics, rank 0 alone checkpoints; rank 0 alone renders and logs the
    # warp pictures (its data row's ranks join the banded forward), and
    # the arrays it hands to the PNG writer — target, ref0 warped, depth —
    # are those a Trainer without the mesh renders from the same state and
    # batch
    fits = [r["steps"]["fit"] for r in runs[mesh_name]]
    assert all(f["step"] == 2 and f["metrics"] == fits[0]["metrics"] for f in fits)
    assert "val_loss" in fits[0]["metrics"] and np.isfinite(fits[0]["metrics"]["loss"])
    assert fits[0]["checkpoints"] == ["epoch_00000.pth"]
    assert fits[0]["logged_images"] == [["depth_000002.png", "tgt_000002.png",
                                         "warp_000002.png"]]
    assert all(not f["pictures"] and not f["logged_images"] for f in fits[1:])
    (got,) = fits[0]["pictures"]
    ref = fits[0]["one_process_pictures"]
    assert [g.shape for g in got] == [(worker.HEIGHT, worker.WIDTH, 3)] * 2 + [
        (worker.HEIGHT, worker.WIDTH)]
    np.testing.assert_array_equal(got[0], ref[0])
    for name, g, r in zip(("warped", "depth"), got[1:], ref[1:]):
        assert _rel_l2(g, r) <= UNIT_RTOL, name
