"""The training loop's observability on the CPU, against the JAX package:
the warp/depth pictures (utils/visualization.py, utils/transforms
.unnormalize_image, geometry/warp.inverse_warp and
inverse_warp_from_matrix, Trainer.log_warps), the wandb images and weight
histograms (utils/logging.MetricLogger, Trainer.fit) with a stub wandb
module, and the zeros-warp collapse warning (geometry/warp
.in_frame_fraction, the warp_in_frame metric, Trainer._warn_if_collapsed).
"""

import io
import os
import sys
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unsupervised_pseuso_lidar_tpu.geometry import warp as jax_warp
from unsupervised_pseuso_lidar_tpu.geometry.se3 import pose_matrix as jax_pose_matrix
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.ops.resample import band_coverage
from unsupervised_pseuso_lidar_tpu.train import trainer as jax_trainer
from unsupervised_pseuso_lidar_tpu.utils import transforms as jax_transforms
from unsupervised_pseuso_lidar_tpu.utils import visualization as jax_vis
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.geometry.se3 import pose_matrix
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    in_frame_fraction,
    inverse_warp,
    inverse_warp_from_matrix,
    warp_coords,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.total import total_loss
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer
from unsupervised_pseuso_lidar_tpu_torch.utils import visualization
from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import unnormalize_image
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
HEIGHT, WIDTH = 48, 80


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _hwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def test_unnormalize_image_matches_jax():
    img = np.random.default_rng(0).standard_normal((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(unnormalize_image(img), jax_transforms.unnormalize_image(img))


@pytest.mark.parametrize("normalized", [True, False])
def test_depth_and_image_pictures_are_jax_bytes(normalized):
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 80.0, (HEIGHT, WIDTH)).astype(np.float32)
    depth[0, :4] = 0.0  # the 1e-6 floor
    img = rng.standard_normal((HEIGHT, WIDTH, 3)).astype(np.float32)
    if not normalized:
        img = rng.uniform(-0.2, 1.2, img.shape).astype(np.float32)
    got = visualization.depth_to_image(depth)
    assert got.dtype == np.uint8 and got.shape == (HEIGHT, WIDTH, 3)
    np.testing.assert_array_equal(got, jax_vis.depth_to_image(depth))
    np.testing.assert_array_equal(visualization.depth_to_image(depth, 50.0),
                                  jax_vis.depth_to_image(depth, 50.0))
    np.testing.assert_array_equal(visualization.image_to_uint8(img, normalized),
                                  jax_vis.image_to_uint8(img, normalized))


def test_save_warp_visualization_writes_jax_pngs(tmp_path):
    rng = np.random.default_rng(2)
    tgt, warped = (rng.standard_normal((HEIGHT, WIDTH, 3)).astype(np.float32)
                   for _ in range(2))
    depth = rng.uniform(1.0, 50.0, (HEIGHT, WIDTH)).astype(np.float32)
    ours = visualization.save_warp_visualization(str(tmp_path / "port"), 12, tgt, warped, depth)
    ref = jax_vis.save_warp_visualization(str(tmp_path / "jax"), 12, tgt, warped, depth)
    assert sorted(ours) == sorted(ref) == ["depth_000012.png", "tgt_000012.png",
                                           "warp_000012.png"]
    for name in ref:
        assert os.path.relpath(ours[name], tmp_path / "port") == os.path.relpath(
            ref[name], tmp_path / "jax")
        with open(ours[name], "rb") as a, open(ref[name], "rb") as b:
            assert a.read() == b.read(), name


def _warp_inputs(image):
    rng = np.random.default_rng(3)
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=2).batches())
    img = (batch["ref_imgs"][:, 0] if image == "scene"
           else rng.standard_normal((2, HEIGHT, WIDTH, 3)).astype(np.float32))
    depth = rng.uniform(2.0, 20.0, (2, HEIGHT, WIDTH)).astype(np.float32)
    pose = (rng.standard_normal((2, 6)) * np.array([0.02] * 3 + [0.2] * 3)).astype(np.float32)
    return img, depth, pose, batch["intrinsics"].astype(np.float32)


def _value_bound(img, coords_atol):
    # both packages compute the sample coordinates in fp32 (to 1e-6 of each
    # other in normalized units, checked below); moving a bilinear sample
    # by d pixels along each axis changes it by at most 2 d L, L the
    # image's largest step between neighbours (the zero padding included)
    step = max(np.abs(np.diff(img, axis=1)).max(), np.abs(np.diff(img, axis=2)).max(),
               np.abs(img).max())
    pixels = coords_atol * (max(HEIGHT, WIDTH) - 1) / 2
    return 1e-5 + 2 * pixels * step


@pytest.mark.parametrize("image", ["scene", "noise"])
@pytest.mark.parametrize("invert", [False, True])
def test_inverse_warp_matches_jax(image, invert):
    img, depth, pose, K = _warp_inputs(image)
    ref = np.asarray(jax_warp.inverse_warp(jnp.asarray(img), jnp.asarray(depth),
                                           jnp.asarray(pose), jnp.asarray(K),
                                           invert_pose=invert))
    got = _hwc(inverse_warp(_nchw(img), torch.from_numpy(depth), torch.from_numpy(pose),
                            torch.from_numpy(K), invert_pose=invert))
    assert 0.0 < (ref == 0).mean() < 0.5  # some samples fall out of frame
    # the coordinates behind both (the port builds the transform in fp64)
    ref_coords = np.asarray(jax_warp.warp_coords(
        jnp.asarray(depth), jax_pose_matrix(jnp.asarray(pose), invert=invert),
        jnp.asarray(K)))
    coords = warp_coords(torch.from_numpy(depth),
                         pose_matrix(torch.from_numpy(pose).double(), invert=invert),
                         torch.from_numpy(K)).numpy()
    coords_err = float(np.abs(coords - ref_coords).max())
    assert coords_err <= 1e-6, coords_err
    np.testing.assert_allclose(got, ref, rtol=0, atol=_value_bound(img, coords_err))


def test_inverse_warp_from_matrix_matches_jax_and_refuses_other_padding():
    img, depth, pose, K = _warp_inputs("scene")
    transform = np.array(jax_pose_matrix(jnp.asarray(pose)))
    ref = np.asarray(jax_warp.inverse_warp_from_matrix(
        jnp.asarray(img), jnp.asarray(depth), jnp.asarray(transform), jnp.asarray(K[0]),
        impl="gather"))
    got = _hwc(inverse_warp_from_matrix(_nchw(img), torch.from_numpy(depth),
                                        torch.from_numpy(transform), torch.from_numpy(K[0])))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_value_bound(img, 1e-6))
    with pytest.raises(ValueError, match="zeros"):
        inverse_warp_from_matrix(_nchw(img), torch.from_numpy(depth),
                                 torch.from_numpy(transform), torch.from_numpy(K[0]),
                                 padding_mode="border")


# --------------------------------------------------------------------------
# Trainer.log_warps against the JAX trainer's, on the same weights
# --------------------------------------------------------------------------


def _config(tmp_path, **action):
    config = Config()
    config.model.depth.name, config.model.pose.name = "DispResNet", "PoseNet"
    config.datasets.augmentation.image_height = HEIGHT
    config.datasets.augmentation.image_width = WIDTH
    config.action.batch_size = 2
    config.action.checkpoint_dir = str(tmp_path / "checkpoints")
    for key, value in action.items():
        setattr(config.action, key, value)
    return config


def _read_png(path):
    with open(path, "rb") as f:
        return np.asarray(Image.open(io.BytesIO(f.read()))).astype(np.int16)


def test_log_warps_matches_jax(tmp_path):
    # flax DispResNet-18 + PoseNet (plain convs) with non-trivial BatchNorm
    # statistics, and the port's Trainer holding the same weights
    rng = np.random.default_rng(0)
    jax_depth = jax_build_model("DispResNet")
    jax_pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    dv = jax.jit(partial(jax_depth.init, train=False))(jax.random.PRNGKey(0), img)
    pv = jax.jit(jax_pose.init)(jax.random.PRNGKey(1), img, [img, img])
    params = {"depth": jax.tree.map(np.asarray, dv["params"]),
              "pose": jax.tree.map(np.asarray, pv["params"])}
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, dv["batch_stats"]))
    ref_trainer = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    ref_trainer.mesh = None
    ref_trainer.config = _config(tmp_path)
    ref_trainer.depth_model, ref_trainer.pose_model = jax_depth, jax_pose
    ref_trainer.state = jax_trainer.TrainState(
        step=0, params=params, batch_stats={"depth": stats, "pose": {}}, opt_state=None)

    trainer = Trainer(_config(tmp_path), device="cpu")
    trainer.state.depth_model.load_state_dict(
        state_dict_from_jax(params["depth"], stats, "DispResNet"), strict=True)
    trainer.state.pose_model.load_state_dict(
        state_dict_from_jax(params["pose"], {}, "PoseNet"), strict=True)

    # normalized float frames: the JAX log_warps reads the batch's images
    # as normalized ones (a uint8 batch would render its raw bytes)
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=6).batches())
    batch = {k: batch[k] for k in ("tgt", "ref_imgs", "intrinsics")}
    ref = ref_trainer.log_warps({k: jnp.asarray(v) for k, v in batch.items()}, step=3,
                                out_dir=str(tmp_path / "jax"))
    got = trainer.log_warps(batch, step=3, out_dir=str(tmp_path / "port"))
    assert sorted(got) == sorted(ref) == ["depth_000003.png", "tgt_000003.png",
                                          "warp_000003.png"]
    for name in ref:
        a, b = _read_png(got[name]), _read_png(ref[name])
        assert a.shape == b.shape == (HEIGHT, WIDTH, 3)
        assert np.abs(a - b).max() <= 1, name
    assert np.array_equal(_read_png(got["tgt_000003.png"]), _read_png(ref["tgt_000003.png"]))
    assert len(np.unique(_read_png(got["warp_000003.png"]))) > 10


# --------------------------------------------------------------------------
# wandb images and histograms
# --------------------------------------------------------------------------


class StubWandb(types.ModuleType):
    """The wandb calls MetricLogger makes, recorded."""

    def __init__(self):
        super().__init__("wandb")
        self.logged = []
        self.inits = []

    def init(self, project=None, config=None):
        self.inits.append(project)

    def Image(self, x):
        return ("image", x)

    def Histogram(self, x):
        return ("histogram", np.asarray(x).size)

    def log(self, payload, step=None):
        self.logged.append((payload, step))


def test_logger_images_and_histograms_are_noops_without_wandb(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` fails
    config = Config()
    config.action.mlops = True
    for logger in (MetricLogger(None), MetricLogger(config)):
        assert logger._wandb is None
        logger.log_images({"x": np.zeros((2, 2, 3), np.uint8)}, step=1)
        logger.log_param_histograms({"pose": torch.nn.Linear(2, 2)}, step=1)
    assert "wandb unavailable" in capsys.readouterr().out


def test_logger_forwards_images_and_histograms_to_wandb(monkeypatch):
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    config = Config()
    config.action.mlops = True
    logger = MetricLogger(config)
    assert logger._wandb is stub and stub.inits == ["unsup-depth-estimation"]
    logger.log_images({"tgt.png": "a/tgt.png"}, step=4)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    logger.log_param_histograms({"depth": net}, step=4)
    (images, s1), (hists, s2) = stub.logged
    assert s1 == s2 == 4 and images == {"tgt.png": ("image", "a/tgt.png")}
    assert hists == {"params/depth/0/weight": ("histogram", 108),
                     "params/depth/0/bias": ("histogram", 4),
                     "params/depth/1/weight": ("histogram", 4),
                     "params/depth/1/bias": ("histogram", 4)}


def test_fit_logs_one_image_set_and_one_histogram_set_an_epoch(tmp_path, monkeypatch):
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.chdir(tmp_path)  # log_warps writes ./images
    config = _config(tmp_path, mlops=True, num_epochs=2, log_freq=100)
    data = SyntheticTripletDataset(2, 2, HEIGHT, WIDTH, seed=1, uint8_images=True)
    trainer = Trainer(config, data, log_fn=MetricLogger(config), device="cpu")
    trainer.fit(make_train_iter=lambda epoch: data.batches(epoch))
    images = [(p, s) for p, s in stub.logged if any(k.endswith(".png") for k in p)]
    hists = [(p, s) for p, s in stub.logged if any(k.startswith("params/") for k in p)]
    assert [s for _, s in images] == [s for _, s in hists] == [2, 4]
    assert sorted(images[-1][0]) == ["depth_000004.png", "tgt_000004.png", "warp_000004.png"]
    assert os.path.exists(tmp_path / "images" / "warping" / "warp_000004.png")
    names = {f"params/{net}/" + n.replace(".", "/")
             for net, model in (("depth", trainer.state.depth_model),
                                ("pose", trainer.state.pose_model))
             for n, _ in model.named_parameters()}
    assert set(hists[0][0]) == names


# --------------------------------------------------------------------------
# the collapse warning
# --------------------------------------------------------------------------


def test_in_frame_fraction_reads_zero_where_band_coverage_does():
    rng = np.random.default_rng(4)
    # every sample out of frame: beyond +-1 by more than a pixel
    out = rng.uniform(1.2, 3.0, (2, HEIGHT, WIDTH, 2)).astype(np.float32)
    out *= rng.choice([-1.0, 1.0], out.shape).astype(np.float32)
    assert float(in_frame_fraction(torch.from_numpy(out))) == 0.0
    assert float(band_coverage(jnp.asarray(out))) == 0.0
    # a normal step's coordinates: both read above 0
    _, depth, pose, K = _warp_inputs("scene")
    coords = warp_coords(torch.from_numpy(depth), pose_matrix(torch.from_numpy(pose)),
                         torch.from_numpy(K))
    assert 0.5 < float(in_frame_fraction(coords)) <= 1.0
    assert float(band_coverage(jnp.asarray(coords.numpy()))) > 0.0
    # the in-image test is band_coverage's: a sample one pixel outside
    # still counts, two do not
    edge = torch.full((1, 1, 4, 2), 0.0)
    px = 2.0 / (WIDTH - 1)
    edge[0, 0, :, 0] = torch.tensor([1.0 + px * 0.999, -1.0 - px * 0.999,
                                     1.0 + 2 * px, -1.0 - 2 * px])
    edge = edge.expand(1, HEIGHT, 4, 2).contiguous()
    edge[..., 1] = 0.0
    coords_hw = torch.zeros(1, HEIGHT, WIDTH, 2)
    coords_hw[:, :, :4] = edge
    coords_hw[:, :, 4:, 0] = 5.0  # out
    assert float(in_frame_fraction(coords_hw)) == pytest.approx(2 / WIDTH)


@pytest.mark.parametrize("mode", ["mean", "min"])
def test_warp_in_frame_metric_of_the_loss(mode):
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=3).batches())
    tgt, refs = _nchw(batch["tgt"]), [_nchw(batch["ref_imgs"][:, i]) for i in range(2)]
    disps = [[torch.full((2, 1, HEIGHT >> s, WIDTH >> s), 0.05) for s in range(2)]
             for _ in range(2)]
    K = torch.from_numpy(batch["intrinsics"])
    poses = torch.from_numpy(batch["oxts"])
    _, _, extra = total_loss(tgt, refs, disps, poses, K, mode=mode, with_coverage=True)
    assert 0.5 < float(extra["warp_in_frame"]) <= 1.0
    _, _, none = total_loss(tgt, refs, disps, poses, K, mode=mode)
    assert "warp_in_frame" not in none
    # a translation that throws every sample out of frame: the collapse
    far = poses.clone()
    far[..., 3] = 1e4
    _, _, extra = total_loss(tgt, refs, disps, far, K, mode=mode, with_coverage=True)
    assert float(extra["warp_in_frame"]) == 0.0


@pytest.mark.parametrize("warp_impl,reported", [("mxu", True), ("pallas", True),
                                                ("gather", False)])
def test_train_step_reports_warp_in_frame_where_jax_reports_coverage(tmp_path, warp_impl,
                                                                     reported):
    config = _config(tmp_path, warp_impl=warp_impl)
    data = SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=1, uint8_images=True)
    metrics = Trainer(config, data, device="cpu").run_epoch(data.batches())
    assert ("warp_in_frame" in metrics) == reported
    if reported:
        assert 0.0 < metrics["warp_in_frame"] <= 1.0


def test_warns_once_on_zero_in_frame_fraction(capsys):
    # as JAX's TestCollapseWarning (tests/test_train.py)
    t = Trainer.__new__(Trainer)  # the guard needs no trainer state
    t._warn_if_collapsed({"warp_in_frame": 0.0, "loss": 0.567})
    assert "zeros-warp" in capsys.readouterr().out
    t._warn_if_collapsed({"warp_in_frame": 0.0, "loss": 0.567})
    assert capsys.readouterr().out == ""  # once per run, not per epoch


def test_silent_on_a_healthy_warp(capsys):
    t = Trainer.__new__(Trainer)
    t._warn_if_collapsed({"warp_in_frame": 0.77})
    t._warn_if_collapsed({})  # warp_impl 'gather': no metric at all
    assert capsys.readouterr().out == ""


def test_run_epoch_warns_when_every_sample_leaves_the_frame(tmp_path, capsys):
    # semi_sup_pose takes the batch's OXTS poses: a 10 km step between the
    # frames throws every sample out of frame, and the epoch's read of the
    # metric warns
    config = _config(tmp_path, warp_impl="mxu", semi_sup_pose=True)
    data = SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=1, uint8_images=True,
                                   tx=1e4)
    trainer = Trainer(config, data, device="cpu")
    metrics = trainer.run_epoch(data.batches())
    assert metrics["warp_in_frame"] == 0.0
    assert "zeros-warp" in capsys.readouterr().out
    trainer.run_epoch(data.batches())
    assert "zeros-warp" not in capsys.readouterr().out
