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
at 128 (the narrowest Reduction1x1 allows). The flax variables
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
from unsupervised_pseuso_lidar_tpu_torch.cli import export as export_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import inference as inference_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import pipeline as pipeline_cli
from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.geometry.oxts import load_velo_scan
from unsupervised_pseuso_lidar_tpu_torch.models.depth.bts import local_planar_guidance
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
    export_bts_serving_checkpoint,
    export_reference_checkpoint,
    load_reference_state,
    load_serving_weights,
    reference_state,
)
from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import create_train_state
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(93)
HEIGHT, WIDTH, NUM_FEATURES = 64, 96, 512
# the five outputs: relative L2 over each map; reduc1x1 and the final
# depth also elementwise (_check_outputs); LPG alone elementwise where its
# denominator is >= 0.05
REL_L2, RTOL, DENOM_MIN = 1e-5, 1e-4, 0.05
# train mode normalizes every one of its 160 BatchNorms by the batch's own
# statistics, which the two fp32 forwards compute apart by ~1e-6: the
# outputs drift to ~1.5e-5 (relative L2) by the decoder
TRAIN_REL_L2 = 1e-4
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


def _image(batch=2):
    return RNG.normal(size=(batch, HEIGHT, WIDTH, 3)).astype(np.float32)


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
    theta = RNG.uniform(0, np.pi / 3, (2, 5, 7))
    phi = RNG.uniform(0, 2 * np.pi, (2, 5, 7))
    plane = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                      np.cos(theta), RNG.uniform(0.1, 80, (2, 5, 7))], -1).astype(np.float32)
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
    img = _image()
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
    img = _image()
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
