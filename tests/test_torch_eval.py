"""Port parity for evaluation: the depth metrics (eval/metrics.py), the
pose metrics (eval/pose.py) and the validation step with the Eigen
protocol and pose metrics, against the JAX package on the same numpy
inputs and the same weights."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.eval import metrics as jax_metrics
from unsupervised_pseuso_lidar_tpu.eval import pose as jax_pose_eval
from unsupervised_pseuso_lidar_tpu.geometry import se3 as jax_se3
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.trainer import TrainState
from unsupervised_pseuso_lidar_tpu.train.trainer import make_eval_step as jax_make_eval_step
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.eval import metrics, pose
from unsupervised_pseuso_lidar_tpu_torch.geometry import se3
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import make_eval_step
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(41)


def _assert_metrics_close(got, ref, rtol=1e-5, atol=0.0):
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=rtol,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("hw", [(375, 1242), (192, 640), (7, 11)])
def test_eigen_crop_mask_matches_jax(hw):
    got = metrics.eigen_crop_mask(*hw)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_metrics.eigen_crop_mask(*hw)))


def test_nanmedian_averages_the_middle_pair():
    # jnp.nanmedian interpolates: the mean of the two middle values at an
    # even count (torch.median would give the lower one); NaN with none
    x = torch.tensor([[4.0, 1.0, 9.0, 2.0, 7.0, 100.0],
                      [3.0, 5.0, 8.0, 1.0, 2.0, 6.0],
                      [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]])
    valid = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 0], [0] * 6], dtype=torch.bool)
    got = metrics._nanmedian(x, valid)
    ref = jnp.nanmedian(jnp.where(jnp.asarray(valid.numpy()), jnp.asarray(x.numpy()),
                                  jnp.nan), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got[0]) == 3.0 and float(got[1]) == 3.0 and torch.isnan(got[2])


def _depth_batch():
    """[3, 24, 40] sparse ground truth (0 = no return, a few beyond 80 m)
    and a prediction off by a per-image scale and noise; image 1 has no
    valid pixel, image 0 an even count."""
    gt = RNG.uniform(2.0, 90.0, (3, 24, 40)).astype(np.float32)
    gt[RNG.uniform(size=gt.shape) < 0.6] = 0.0
    gt[1] = 0.0
    inside = (gt[0] > 1e-3) & (gt[0] < 80.0)
    if inside.sum() % 2:  # an even count of valid pixels in image 0
        gt[0][np.argwhere(inside)[0][0], np.argwhere(inside)[0][1]] = 0.0
    scale = np.array([0.3, 2.0, 1.7], np.float32)[:, None, None]
    pred = (np.where(gt > 0, gt, 20.0) * scale
            * RNG.uniform(0.8, 1.2, gt.shape)).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("eigen,median_scale", [(False, False), (False, True),
                                                (True, False), (True, True)])
def test_compute_errors_matches_jax(eigen, median_scale):
    # per image, then the mean over images with a valid pixel: rtol 1e-5
    gt, pred = _depth_batch()
    jax_mask = mask = None
    if eigen:
        crop = metrics.eigen_crop_mask(24, 40)
        mask = crop & (torch.from_numpy(gt) > 1e-3) & (torch.from_numpy(gt) < 80.0)
        jax_mask = jnp.asarray(mask.numpy())
    ref = jax_metrics.compute_errors(jnp.asarray(gt), jnp.asarray(pred), mask=jax_mask,
                                     median_scale=median_scale)
    got = metrics.compute_errors(torch.from_numpy(gt), torch.from_numpy(pred), mask=mask,
                                 median_scale=median_scale)
    assert sorted(got) == sorted(metrics.METRICS)
    _assert_metrics_close(got, ref)
    # one image ([H, W]) with none valid: all zeros, as in JAX
    single = metrics.compute_errors(torch.from_numpy(gt[1]), torch.from_numpy(pred[1]),
                                    median_scale=median_scale)
    _assert_metrics_close(single, jax_metrics.compute_errors(
        jnp.asarray(gt[1]), jnp.asarray(pred[1]), median_scale=median_scale))


def test_euler2mat_matches_jax():
    angles = RNG.uniform(-np.pi, np.pi, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.euler2mat(torch.from_numpy(angles)).numpy(),
                               np.asarray(jax_se3.euler2mat(jnp.asarray(angles))),
                               atol=1e-6)


@pytest.mark.parametrize("gt_mode", ["axis_angle", "euler"])
def test_pose_errors_match_jax(gt_mode):
    # [B, N, 6] snippets, rotations up to ~0.3 rad (the two conventions
    # diverge there); rtol 1e-5
    pred = np.concatenate([RNG.normal(0, 0.1, (4, 2, 3)), RNG.normal(0, 0.5, (4, 2, 3))],
                          -1).astype(np.float32)
    gt = (pred + RNG.normal(0, 0.05, pred.shape)).astype(np.float32)
    ref = jax_pose_eval.pose_errors(jnp.asarray(pred), jnp.asarray(gt), gt_mode=gt_mode)
    got = pose.pose_errors(torch.from_numpy(pred), torch.from_numpy(gt), gt_mode=gt_mode)
    _assert_metrics_close(got, ref)
    assert float(got["rot_err_deg"]) > 0.1


HEIGHT, WIDTH = 64, 96


def test_pose_forward_matches_jax():
    # the bare pose forward on a normalized NCHW batch (JAX: NHWC) with
    # the same PoseNet weights; atol 1e-5, as the model tests
    jax_net = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jax_net.init)(jax.random.PRNGKey(4), img,
                                                             [img, img])["params"])
    tgt = RNG.normal(size=(2, HEIGHT, WIDTH, 3)).astype(np.float32)
    refs = RNG.normal(size=(2, 2, HEIGHT, WIDTH, 3)).astype(np.float32)
    ref = jax_pose_eval.pose_forward(jax_net, {"pose": params}, {"pose": {}},
                                     {"tgt": jnp.asarray(tgt), "ref_imgs": jnp.asarray(refs)})
    net = build_model("PoseNet", device="cpu")
    net.load_state_dict(state_dict_from_jax(params, {}, "PoseNet"))
    batch = {"tgt": torch.from_numpy(tgt).permute(0, 3, 1, 2),
             "ref_imgs": torch.from_numpy(refs).permute(0, 1, 4, 2, 3)}
    with torch.no_grad():
        got = pose.pose_forward(net, batch)
    assert got.shape == (2, 2, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_eval_step_with_eigen_protocol_and_pose_metrics_matches_jax():
    # DispResNet-18 + PoseNet (plain convs) with the same weights, one
    # synthetic batch with groundtruth and oxts, loss_mode 'mean' (the
    # default): the loss at rel 1e-4 (the eval step's tolerance), every
    # pose and depth metric at rel 1e-4 (the depth map itself agrees to
    # rel 1e-4), and the same metric names
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
    state = TrainState(step=0, params=params, batch_stats={"depth": stats, "pose": {}},
                       opt_state=None)
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=3,
                                         uint8_images=True).batches())
    jax_step = jax_make_eval_step(jax_depth, jax_pose, warp_impl="gather",
                                  eval_protocol="eigen", pose_metrics=True)
    ref, _ = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()})

    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(state_dict_from_jax(params["depth"], stats, "DispResNet"))
    pose_net = build_model("PoseNet", device="cpu")
    pose_net.load_state_dict(state_dict_from_jax(params["pose"], {}, "PoseNet"))
    step = make_eval_step(depth, pose_net, eval_protocol="eigen", pose_metrics=True,
                          device="cpu")
    got, _ = step(batch)
    assert sorted(got) == sorted(["loss", "pose_ate", "pose_ate_unscaled",
                                  "pose_rot_err_deg", "pose_scale", *metrics.METRICS])
    assert all(np.isfinite(float(v)) for v in got.values())
    _assert_metrics_close(got, ref, rtol=1e-4, atol=1e-6)
