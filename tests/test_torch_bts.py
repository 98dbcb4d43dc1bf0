"""Port parity for BtsModel, the pseudo-LiDAR serving model: the local
planar guidance, the whole model in eval and train mode, its weight
bridge, reference-schema export and import, the ROS node's serving blob
(export_bts_serving_checkpoint, cli.export --format bts-serving) and
cli.pipeline serving it, against the JAX package on the same numpy inputs
and weights.

DenseNet-161 cannot be narrowed, so the model runs at full width on a
small image (64x96, batch 2). The decoder keeps num_features 512 too: the
JAX package's BTS state-dict mapping is written for 512 (checkpoint.py
_bts_mapping's nf), and the export, import and serving-blob checks go
through it; the port's mapping reads the width from the weights, checked
at 128, and at 64 and 96, where the final Reduction1x1 cascade is empty
(the narrow-decoder tests, 64x64). The flax variables
are drawn once for the module (tests/test_torch_zoo.random_variables:
shapes from jax.eval_shape, values seeded), so the file compiles BTS's
apply, not its init.

LPG divides by n1·u + n2·v + n3, which comes near 0 at some pixels (θ <
π/3 keeps n3 >= 0.5, but |n1·u + n2·v| reaches ~0.61): the plane-depth
outputs are held at a relative L2 bound over the map, and the LPG alone
elementwise where the denominator is at least 0.05.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_data import DATE, DRIVE, mini_kitti  # noqa: F401
from tests.test_torch_serve import _assert_clouds_match
from tests.test_torch_train import STEP_SETTINGS, _grads_in_opt_state
from tests.test_torch_zoo import assert_state_equal, nchw, nhwc, random_variables
from unsupervised_pseuso_lidar_tpu.cli import inference as jax_inference_cli
from unsupervised_pseuso_lidar_tpu.cli import pipeline as jax_pipeline_cli
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.models.depth import bts as jax_bts
from unsupervised_pseuso_lidar_tpu.train import trainer as jax_trainer
from unsupervised_pseuso_lidar_tpu.train.checkpoint import (
    export_bts_serving_checkpoint as jax_export_bts_serving,
)
from unsupervised_pseuso_lidar_tpu.train.checkpoint import (
    export_torch_state,
    import_torch_state,
)
from unsupervised_pseuso_lidar_tpu.train.trainer import make_train_step_body
from unsupervised_pseuso_lidar_tpu_torch.cli import export as export_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import inference as inference_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import pipeline as pipeline_cli
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.geometry.oxts import load_velo_scan
from unsupervised_pseuso_lidar_tpu_torch.losses.total import total_loss
from unsupervised_pseuso_lidar_tpu_torch.models.depth.bts import local_planar_guidance
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
    export_bts_serving_checkpoint,
    export_reference_checkpoint,
    load_pretrained_depth,
    load_reference_state,
    load_serving_weights,
    reference_state,
)
from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    batch_to_device,
    create_train_state,
    forward_batch,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    normalize_uint8_batch,
)
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
HEIGHT, WIDTH, NUM_FEATURES = 64, 96, 512
# the five outputs: relative L2 over each map; reduc1x1 and the final
# depth also elementwise (_check_outputs); LPG alone elementwise where its
# denominator is >= 0.05
REL_L2, RTOL, DENOM_MIN = 1e-5, 1e-4, 0.05
# train mode normalizes every one of its 160 BatchNorms by the batch's own
# statistics, which the two fp32 forwards compute apart by ~1e-6: the
# outputs drift to ~1.5e-5 (relative L2) by the decoder
TRAIN_REL_L2 = 1e-4
# the training step against JAX's (test_train_step_matches_jax): its
# metrics (rel), and JAX's fp32 gradient against the port's step in fp64
# (rel L2 of the whole gradient, and of each leaf: a leaf that enters the
# loss otherwise than in JAX moves by O(1))
STEP_LOSS_RTOL, STEP_FP64_REL_L2, STEP_FP64_LEAF_REL_L2 = 1e-6, 5e-2, 1e-1
# BatchNorm running statistics after a train-mode forward: rel and abs
# (DenseNet-161 normalizes 160 times by batch statistics in train mode;
# ResNet-50's bound, tests/test_torch_resnets.py)
STATS_TOL = 1e-4


@pytest.fixture(scope="module")
def bts():
    """(flax BtsModel, its variables as numpy trees, the port's BtsModel
    with them bridged in)."""
    model = jax_build_model("BtsModel", num_features=NUM_FEATURES)
    variables = random_variables(model, jnp.zeros((1, HEIGHT, WIDTH, 3)), seed=5)
    port = build_model("BtsModel", device="cpu", num_features=NUM_FEATURES)
    port.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                             "BtsModel"))
    return model, variables, port


def _image(seed, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, HEIGHT, WIDTH, 3)).astype(np.float32)


def _denominators(plane_eq, upratio):
    """|n1·u + n2·v + n3| of local_planar_guidance at every fine pixel."""
    r = upratio
    n = np.repeat(np.repeat(plane_eq, r, axis=1), r, axis=2)
    offsets = (np.arange(r, dtype=np.float32) - (r - 1) * 0.5) / r
    u = np.tile(offsets, plane_eq.shape[2])[None, None, :]
    v = np.tile(offsets, plane_eq.shape[1])[None, :, None]
    return np.abs(n[..., 0] * u + n[..., 1] * v + n[..., 2])


def _rel_l2(a, b):
    return float(np.linalg.norm((a - b).astype(np.float64)) / np.linalg.norm(b.astype(np.float64)))


@pytest.mark.parametrize("upratio", [8, 4, 2])
def test_local_planar_guidance_matches_jax(upratio):
    # unit normals with θ < π/3 and distances in (0, 80), as
    # Reduction1x1 emits them; the worst pixels come near a zero
    # denominator
    rng = np.random.default_rng(93)
    theta = rng.uniform(0, np.pi / 3, (2, 5, 7))
    phi = rng.uniform(0, 2 * np.pi, (2, 5, 7))
    plane = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                      np.cos(theta), rng.uniform(0.1, 80, (2, 5, 7))], -1).astype(np.float32)
    ref = np.asarray(jax_bts.local_planar_guidance(jnp.asarray(plane), upratio))
    got = local_planar_guidance(nchw(plane), upratio).numpy()
    assert got.shape == ref.shape == (2, 5 * upratio, 7 * upratio)
    keep = _denominators(plane, upratio) >= DENOM_MIN
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6)
    assert _rel_l2(got, ref) <= 1e-6


def _check_outputs(got, ref, rel_l2=REL_L2):
    """The five outputs [B, 1, H, W] against JAX's [B, H, W, 1]: each at
    relative L2 `rel_l2` over the map, reduc1x1 (a sigmoid) and the final
    depth (80·sigmoid) also elementwise at RTOL of their largest value."""
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = nhwc(g), np.asarray(r)
        assert g.shape == r.shape == (r.shape[0], HEIGHT, WIDTH, 1), i
        assert np.isfinite(g).all(), i
        assert _rel_l2(g, r) <= rel_l2, (i, _rel_l2(g, r))
        if i in (3, 4):
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=RTOL * float(np.abs(r).max()))


def test_forward_matches_jax(bts):
    # eval mode: (d8, d4, d2, reduc1x1, final depth), each [B, 1, H, W]
    model, variables, port = bts
    img = _image(93)
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port.eval()(nchw(img))
    _check_outputs(got, ref)
    final = np.asarray(ref[4])
    assert 0.5 < final.min() and final.max() < 79.5  # the sigmoid is not saturated


def test_train_mode_forward_and_running_statistics_match_jax(bts):
    # train mode: batch statistics in every BatchNorm, and the running
    # statistics after the forward by flax's rule (per-instance momentum:
    # 0.1 in the encoder, 0.01 in the decoder)
    model, variables, _ = bts
    port = build_model("BtsModel", device="cpu", num_features=NUM_FEATURES)
    port.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                             "BtsModel"))
    img = _image(94)
    ref, mutated = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(img))
    got = port.train()(nchw(img))
    _check_outputs(got, ref, TRAIN_REL_L2)
    new_state = state_dict_from_jax(variables["params"], mutated["batch_stats"], "BtsModel")
    buffers = dict(port.named_buffers())
    moved = 0
    for key, value in new_state.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[key].numpy(), value.numpy(), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=key)
            moved += 1
    assert moved == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    assert port.decoder.bn5.momentum == 0.01 and port.decoder.bn5.eps == 1.1e-5
    assert port.encoder.base_model.norm0.momentum == 0.1
    inner = port.decoder.daspp_6.atrous_conv.aconv_sequence[2]
    assert (inner.momentum, inner.eps) == (0.01, 1e-5)


def test_state_dicts_match_jax_export_and_import(bts):
    # the bridge equals export_torch_state key for key, and at
    # num_features 128 loads strictly into a port model of that width; the
    # port's reference_state is the export; a reference state dict of
    # other weights loads into the port as JAX's import_torch_state takes it
    model, variables, port = bts
    params, stats = variables["params"], variables["batch_stats"]
    ref = export_torch_state(params, stats, "BtsModel")
    assert_state_equal(state_dict_from_jax(params, stats, "BtsModel"), ref)
    assert_state_equal(reference_state(port), ref)
    narrow = random_variables(jax_build_model("BtsModel", num_features=128),
                              jnp.zeros((1, 64, 64, 3)), seed=6)
    narrow_state = state_dict_from_jax(narrow["params"], narrow["batch_stats"], "BtsModel")
    narrow_port = build_model("BtsModel", device="cpu", num_features=128)
    narrow_port.load_state_dict(narrow_state)
    assert "decoder.reduc1x1.reduc.final.0.weight" in narrow_state

    other = random_variables(model, jnp.zeros((1, HEIGHT, WIDTH, 3)), seed=7)
    blob = export_torch_state(other["params"], other["batch_stats"], "BtsModel")
    fresh = build_model("BtsModel", device="cpu", num_features=NUM_FEATURES)
    load_reference_state(fresh, {k: torch.from_numpy(np.array(v)) for k, v in blob.items()})
    new_params, new_stats = import_torch_state(params, stats, blob, "BtsModel")
    assert_state_equal(fresh.state_dict(), state_dict_from_jax(new_params, new_stats, "BtsModel"))


# the narrow decoders: JAX's Reduction1x1 cascade is empty where its width
# (num_features // 32) is under 4, and its reduc1x1 passes up1's
# num_features // 16 channels through into iconv1. Every output is held at
# NARROW_ATOL max abs on the scale of the plane depths (divided by
# max_depth): the final depth, max_depth · sigmoid, is metres up to 80,
# where one fp32 ulp is ~4e-6, so its sigmoid is compared
NARROW_SIZE, NARROW_ATOL, MAX_DEPTH = 64, 1e-5, 80.0


def _narrow(num_features, seed):
    model = jax_build_model("BtsModel", num_features=num_features)
    variables = random_variables(model, jnp.zeros((1, NARROW_SIZE, NARROW_SIZE, 3)), seed=seed)
    port = build_model("BtsModel", device="cpu", num_features=num_features)
    port.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                             "BtsModel"), strict=True)
    return model, variables, port.eval()


@pytest.mark.parametrize("num_features", [64, 96])
def test_narrow_decoder_matches_jax(num_features):
    # eval mode at 64x64: all five outputs at NARROW_ATOL max abs (the
    # final depth over max_depth), reduc1x1 with num_features // 16
    # channels as in JAX
    model, variables, port = _narrow(num_features, seed=num_features)
    img = np.random.default_rng(num_features).normal(
        size=(1, NARROW_SIZE, NARROW_SIZE, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port(nchw(img))
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = nhwc(g), np.asarray(r)
        channels = num_features // 16 if i == 3 else 1
        assert g.shape == r.shape == (1, NARROW_SIZE, NARROW_SIZE, channels), i
        assert np.isfinite(g).all(), i
        scale = MAX_DEPTH if i == 4 else 1.0
        np.testing.assert_allclose(g / scale, r / scale, rtol=0, atol=NARROW_ATOL,
                                   err_msg=str(i))


def test_narrow_decoder_reference_checkpoint_round_trip(tmp_path):
    # num_features 64: the reference-schema .pth of the port's model loads
    # strictly into a fresh one, tensor for tensor, with the wider conv1
    _, _, port = _narrow(64, seed=65)
    assert port.decoder.conv1[0].weight.shape[1] == 2 * (64 // 16) + 3
    pose = build_model("PoseNet", device="cpu")
    path = str(tmp_path / "narrow.pth")
    export_reference_checkpoint(port, pose, path)
    fresh = build_model("BtsModel", device="cpu", num_features=64)
    load_pretrained_depth(fresh, path)
    assert_state_equal(fresh.state_dict(), port.state_dict())


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------


def _port_step_grads(variables, pose_variables, batch, dtype):
    """The port's training-step loss and parameter gradients {net.key}
    (fp64) of BtsModel + PoseNet with the flax variables, the models and
    the normalized batch in `dtype` (forward_batch and total_loss with
    STEP_SETTINGS, as the train step runs them)."""
    depth = build_model("BtsModel", device="cpu", num_features=NUM_FEATURES)
    depth.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                              "BtsModel"))
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(state_dict_from_jax(pose_variables["params"], {}, "PoseNet"))
    depth.to(dtype)
    pose.to(dtype)
    port_batch = normalize_uint8_batch(batch_to_device(batch, torch.device("cpu")))
    port_batch = {k: v.to(dtype) for k, v in port_batch.items()}
    disps_tgt, disps_ref0, poses = forward_batch(depth, pose, port_batch, train=True)
    reproj, smooth, _ = total_loss(
        port_batch["tgt"], [port_batch["ref_imgs"][:, 0], port_batch["ref_imgs"][:, 1]],
        [disps_tgt, disps_ref0], poses, port_batch["intrinsics"], mode="min",
        **STEP_SETTINGS)
    (reproj + smooth).backward()
    return float(reproj + smooth), {f"{net}.{k}": p.grad.double()
                                    for net, model in (("depth", depth), ("pose", pose))
                                    for k, p in model.named_parameters()}


def test_train_step_matches_jax(bts):
    # one training step of BtsModel + PoseNet(s2d_convs=0) at 64x96, batch
    # 2, fp32, 'min' with test_torch_train's settings, against JAX's
    # make_train_step_body with the gather warp: BTS's five outputs enter
    # both losses as five full-resolution "disparities" (JAX's
    # forward_batch), so the metrics agree at rel STEP_LOSS_RTOL. The pose
    # head's bias moves the warp by a few pixels (tests/test_torch_train's
    # docstring). The gradient of this step is ill-conditioned in fp32
    # (160 train-mode BatchNorms, down to 2x3 pixels a map at 1/32): the
    # port's fp32 step, JAX's and the port's own under 1e-7 relative
    # weight noise all sit 1e-3 – 4e-2 per leaf from each other (on a
    # CPU), so the reference is the port's step evaluated in fp64. The
    # port's fp32 gradient is at least as near to it as JAX's fp32 one
    # (flat rel L2: 4.8e-3 and 1.8e-2 at batch seed 1, 1.5e-3 and 8.9e-3
    # at seed 2), and JAX's within STEP_FP64_REL_L2 of it, each of its
    # leaves and the port's within STEP_FP64_LEAF_REL_L2 (worst leaves at
    # seed 1: JAX's 3.5e-2, the port's 9.4e-3). JAX's step cannot run in
    # fp64: it casts the normalized images and the nets' outputs to fp32
    # before the loss (its train/trainer.py:226, :273-278), and the warp
    # its coordinates (geometry/warp.py:83-86, ops/resample.py:134-135)
    model, variables, _ = bts
    pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    pose_variables = random_variables(pose, img, [img, img], seed=3)
    head = pose_variables["params"]["TorchConv_7"]["Conv_0"]
    head["bias"] = (np.random.default_rng(5).normal(size=(2, 6)) * np.array(
        [0.005] * 3 + [0.03] * 3) / 0.06).reshape(-1).astype(np.float32)
    params = {"depth": variables["params"], "pose": pose_variables["params"]}
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=1,
                                         uint8_images=True).batches())
    tx = _grads_in_opt_state()
    body = make_train_step_body(model, pose, tx, loss_mode="min", warp_impl="gather",
                                **STEP_SETTINGS)
    state = jax_trainer.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                                   batch_stats={"depth": variables["batch_stats"], "pose": {}},
                                   opt_state=tx.init(params))
    new_state, ref = jax.jit(body)(state, {k: jnp.asarray(batch[k]) for k in
                                           ("tgt", "ref_imgs", "intrinsics")})
    grads = jax.tree.map(np.asarray, new_state.opt_state)
    jax_grads = {f"{net}.{k}": torch.from_numpy(np.asarray(v)).double()
                 for net, name in (("depth", "BtsModel"), ("pose", "PoseNet"))
                 for k, v in state_dict_from_jax(grads[net], None, name).items()}

    depth = build_model("BtsModel", device="cpu", num_features=NUM_FEATURES)
    depth.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"],
                                              "BtsModel"))
    pose_net = build_model("PoseNet", device="cpu")
    pose_net.load_state_dict(state_dict_from_jax(pose_variables["params"], {}, "PoseNet"))
    optimizer = make_optimizer(load_config("configs/tpu_v5e.yaml"), depth, pose_net)
    port_state = TrainState(depth, pose_net, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))
    got = make_train_step(port_state, device="cpu", loss_mode="min", **STEP_SETTINGS)(batch)
    port_grads = {f"{net}.{k}": p.grad.double()
                  for net, model in (("depth", depth), ("pose", pose_net))
                  for k, p in model.named_parameters()}
    for key in ref:
        rel = abs(float(got[key]) / float(ref[key]) - 1.0)
        print(f"{key}: rel {rel:.3g}")
        assert rel <= STEP_LOSS_RTOL, (key, rel)

    loss64, exact = _port_step_grads(variables, pose_variables, batch, torch.float64)
    assert abs(float(got["loss"]) / loss64 - 1.0) <= STEP_LOSS_RTOL
    assert sorted(port_grads) == sorted(jax_grads) == sorted(exact)
    keys = sorted(exact)

    def flat(tree):
        return torch.cat([tree[k].reshape(-1) for k in keys])

    def leaf_rels(a, b):
        return {k: _rel_l2(a[k].numpy(), b[k].numpy()) for k in keys}

    def leaves(a, b):
        rels = leaf_rels(a, b)
        worst = max(rels, key=rels.get)
        return f"leaves median {np.median(list(rels.values())):.3g}, worst {rels[worst]:.3g} ({worst})"

    port_rel = _rel_l2(flat(port_grads).numpy(), flat(exact).numpy())
    jax_rel = _rel_l2(flat(jax_grads).numpy(), flat(exact).numpy())
    print(f"to the fp64 step: port {port_rel:.3g} ({leaves(port_grads, exact)}), JAX "
          f"{jax_rel:.3g} ({leaves(jax_grads, exact)}); port to JAX "
          f"{leaves(port_grads, jax_grads)}")
    assert port_rel <= jax_rel, (port_rel, jax_rel)
    assert jax_rel <= STEP_FP64_REL_L2, jax_rel
    for grads in (jax_grads, port_grads):
        rels = leaf_rels(grads, exact)
        worst = max(rels, key=rels.get)
        assert rels[worst] <= STEP_FP64_LEAF_REL_L2, (worst, rels[worst])


def test_bts_serving_blob_matches_jax(bts, tmp_path):
    # {"model": {"module." + key: tensor}}: equal key for key and value
    # for value to JAX's export_bts_serving_checkpoint of the same
    # weights, and loads strictly (prefix dropped) into a fresh BtsModel
    _, variables, port = bts
    ours = export_bts_serving_checkpoint(port, str(tmp_path / "ours.pth"))
    theirs = jax_export_bts_serving(variables["params"], variables["batch_stats"],
                                    str(tmp_path / "theirs.pth"))
    assert sorted(ours) == sorted(theirs) == ["model"]
    assert all(k.startswith("module.") for k in ours["model"])
    assert_state_equal({k: v.numpy() for k, v in ours["model"].items()},
                       {k: v.numpy() for k, v in theirs["model"].items()})
    loaded = torch.load(str(tmp_path / "ours.pth"), map_location="cpu", weights_only=True)
    fresh = build_model("BtsModel", device="cpu", num_features=NUM_FEATURES)
    fresh.load_state_dict({k.removeprefix("module."): v for k, v in loaded["model"].items()})
    assert_state_equal(fresh.state_dict(), port.state_dict())


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def _without_flax_init(monkeypatch, bts):
    """JAX's create_train_state, for the CLIs, with the fixture's variables
    in place of a flax init (which the .pth would overwrite): the config's
    BtsModel and a zero PoseNet."""
    _, variables, _ = bts

    def jax_state(config, rng, *args, **kwargs):
        model = jax_build_model(config.model.depth.name, **config.model.depth.kwargs)
        pose = jax_build_model("PoseNet")
        img = jnp.zeros((1, HEIGHT, WIDTH, 3))
        pose_params = jax.eval_shape(pose.init, rng, img, [img, img])["params"]
        params = {"depth": variables["params"],
                  "pose": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), pose_params)}
        state = jax_trainer.TrainState(step=0, params=params,
                                       batch_stats={"depth": variables["batch_stats"], "pose": {}},
                                       opt_state=None)
        return state, model, pose, None

    monkeypatch.setattr(jax_trainer, "create_train_state", jax_state)


@pytest.fixture(scope="module")
def bts_config(bts, tmp_path_factory):
    """A BtsModel + PoseNet config at 64x96, the fixture's weights as a
    reference-schema .pth and as the ROS serving blob. Its max_depth is 2
    m: mini-KITTI's camera is the full frame's, so on the 64x96 frames
    every pixel lies above the principal point, and the projector's 1 m
    height crop keeps only points nearer than a few meters."""
    _, _, port = bts
    root = tmp_path_factory.mktemp("bts")
    raw = {"model": {"name": "bts", "depth": {"name": "BtsModel", "max_depth": 2.0},
                     "pose": {"name": "PoseNet"}},
           "datasets": {"augmentation": {"image_height": HEIGHT, "image_width": WIDTH}},
           "action": {"checkpoint_dir": str(root / "ckpt")}}
    config = root / "bts.yaml"
    config.write_text(yaml.safe_dump(raw))
    pose = build_model("PoseNet", torch.Generator().manual_seed(1), device="cpu")
    pth = str(root / "bts.pth")
    export_reference_checkpoint(port, pose, pth)
    blob = str(root / "bts_serving.pth")
    export_bts_serving_checkpoint(port, blob)
    return str(config), pth, blob


def test_serving_weights_take_the_ros_blob(bts, bts_config):
    # load_serving_weights takes the ROS node's blob (module.-prefixed
    # under "model") as it takes the reference .pth
    _, _, port = bts
    config_path, pth, blob = bts_config
    config = load_config(config_path)
    for source in (pth, blob):
        state = create_train_state(config, torch.Generator().manual_seed(9), device="cpu")
        assert load_serving_weights(config, state, torch_checkpoint=source) == source
        assert_state_equal(state.depth_model.state_dict(), port.state_dict())


def test_pipeline_cli_serves_bts_like_jax(bts, bts_config, mini_kitti, tmp_path,  # noqa: F811
                                          capsys, monkeypatch):
    # cli.pipeline --config <BtsModel> over mini-KITTI: the metric depth
    # (BTS's last output) projected to the same clouds as JAX's CLI from
    # the same .pth (points atol 1e-3 m, < 0.1 % of pixels apart); the
    # port serves the ROS blob the same. JAX's create_train_state is given
    # the fixture's model (its flax init would only be overwritten by the
    # .pth)
    config_path, pth, blob = bts_config
    _without_flax_init(monkeypatch, bts)
    image_dir = os.path.join(mini_kitti["kitti"], DATE, DRIVE, "image_02", "data")
    calib = os.path.join(mini_kitti["kitti"], DATE)
    common = ["--images", image_dir, "--calib", calib, "--config", config_path,
              "--height", str(HEIGHT), "--width", str(WIDTH), "--max-frames", "2",
              "--queue-size", "8", "--format", "bin"]
    for name, source in (("port", pth), ("blob", blob)):
        stats = pipeline_cli.main([*common, "--torch-checkpoint", source,
                                   "--save-dir", str(tmp_path / name), "--device", "cpu"])
        assert stats["frames"] == 2
    jax_pipeline_cli.main([*common, "--torch-checkpoint", pth, "--save-dir",
                           str(tmp_path / "jax")])
    out = capsys.readouterr().out
    assert out.count("serving BtsModel weights from") == 3
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == [f"cloud_{i:06d}.bin" for i in range(2)]
    cal = Calibration(calib)
    for name in files:
        ours = load_velo_scan(str(tmp_path / "port" / name))
        blob_cloud = load_velo_scan(str(tmp_path / "blob" / name))
        theirs = load_velo_scan(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(ours, blob_cloud)
        _assert_clouds_match(ours, theirs, cal)


def test_cli_export_writes_the_bts_serving_blob(bts, bts_config, tmp_path, capsys):
    # --format bts-serving from the config's serving weights (here the
    # .pth); a config of another depth model is refused as JAX refuses it
    _, _, port = bts
    config_path, pth, _ = bts_config
    out = str(tmp_path / "serving.pth")
    assert export_cli.main(["--config", config_path, "--torch-checkpoint", pth, "--out", out,
                            "--format", "bts-serving", "--device", "cpu"]) is None
    assert "BTS serving blob" in capsys.readouterr().out
    blob = torch.load(out, map_location="cpu", weights_only=True)
    assert_state_equal({k.removeprefix("module."): v for k, v in blob["model"].items()},
                       port.state_dict())
    with pytest.raises(SystemExit):
        export_cli.main(["--config", "configs/test_config.yaml", "--out", out,
                         "--format", "bts-serving", "--device", "cpu"])
    assert "requires model.depth.name: BtsModel" in capsys.readouterr().err


def test_inference_cli_serves_bts_first_output_like_jax(bts, bts_config, mini_kitti,  # noqa: F811
                                                        tmp_path, monkeypatch):
    # JAX's cli.inference takes outputs[0] through disp_to_depth for every
    # model, BtsModel too (its 8x8 plane depth / max_depth read as a
    # disparity; ROADMAP.md §3): the port does the same, depth at rel 1e-4
    config_path, pth, _ = bts_config
    _without_flax_init(monkeypatch, bts)
    image = os.path.join(mini_kitti["kitti"], DATE, DRIVE, "image_02", "data", "0000000001.png")
    argv = ["--config", config_path, "--image", image, "--torch-checkpoint", pth]
    depth = inference_cli.main([*argv, "--device", "cpu"])
    ref = np.asarray(jax_inference_cli.main(argv))
    assert depth.shape == ref.shape == (HEIGHT, WIDTH)
    np.testing.assert_allclose(depth, ref, rtol=1e-4)
    # 1 / (10 · d + 0.01) of a plane depth d / max_depth in (0, ~1]: not metric
    assert float(depth.max()) < 100.0 and float(depth.min()) > 0.0
