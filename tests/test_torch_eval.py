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
from unsupervised_pseuso_lidar_tpu.train.trainer import normalize_uint8_batch as jax_normalize
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.eval import metrics, pose
from unsupervised_pseuso_lidar_tpu_torch.geometry import se3
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import make_eval_step
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)


def _assert_metrics_close(got, ref, rtol=1e-5, atol=0.0):
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=rtol,
                                   atol=atol, err_msg=key)


def _rotation_fp64(vec):
    """[..., 3] axis-angle -> [..., 3, 3] in float64 numpy, by the JAX
    package's formula (geometry/se3.rot_from_axisangle, 1e-7 regularizer)."""
    angle = np.linalg.norm(vec, axis=-1, keepdims=True)
    a = vec / (angle + 1e-7)
    ca, sa = np.cos(angle)[..., None], np.sin(angle)[..., None]
    cross = np.zeros(vec.shape[:-1] + (3, 3))
    cross[..., 0, 1], cross[..., 0, 2] = -a[..., 2], a[..., 1]
    cross[..., 1, 0], cross[..., 1, 2] = a[..., 2], -a[..., 0]
    cross[..., 2, 0], cross[..., 2, 1] = -a[..., 1], a[..., 0]
    return ca * np.eye(3) + sa * cross + (1.0 - ca) * a[..., :, None] * a[..., None, :]


# how far fp32 moves cos = (trace - 1) / 2 of a product of two rounded
# rotations, in units of 2^-24 (one ulp of the trace next to 3 is 4 units)
F32_COS_UNITS = 8


def rot_err_oracle(pred, gt):
    """[..., 6] axis-angle pose pairs -> (their mean rotation error in
    degrees, the angle of R_pred R_gt^T as eval/pose.py defines it, in
    float64 numpy; the most an fp32 evaluation of that mean can be off:
    each pose's cos moved by F32_COS_UNITS · 2^-24 either way). At
    sub-degree angles the arccos next to 1 makes the second a few percent
    of the first."""
    pred, gt = np.asarray(pred, np.float64), np.asarray(gt, np.float64)
    rel = _rotation_fp64(pred[..., :3]) @ np.swapaxes(_rotation_fp64(gt[..., :3]), -1, -2)
    cos = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos)
    d = F32_COS_UNITS * 2.0 ** -24
    shift = np.maximum(np.arccos(np.clip(cos - d, -1.0, 1.0)) - theta,
                       theta - np.arccos(np.clip(cos + d, -1.0, 1.0)))
    return float(np.degrees(theta.mean())), float(np.degrees(shift.mean()))


def assert_rot_err_matches(got, ref, pred, gt, rtol):
    """The port's float64 rotation error `got` against the oracle on the
    reference's poses (pred, gt) at rtol, and the JAX package's fp32 value
    `ref` against the same oracle within its rounding bound."""
    exact, bound = rot_err_oracle(pred, gt)
    np.testing.assert_allclose(float(got), exact, rtol=rtol, atol=1e-12)
    assert abs(float(ref) - exact) <= bound, (float(ref), exact, bound)


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


def _depth_batch(rng):
    """[3, 24, 40] sparse ground truth (0 = no return, a few beyond 80 m)
    and a prediction off by a per-image scale and noise; image 1 has no
    valid pixel, image 0 an even count."""
    gt = rng.uniform(2.0, 90.0, (3, 24, 40)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.6] = 0.0
    gt[1] = 0.0
    inside = (gt[0] > 1e-3) & (gt[0] < 80.0)
    if inside.sum() % 2:  # an even count of valid pixels in image 0
        gt[0][np.argwhere(inside)[0][0], np.argwhere(inside)[0][1]] = 0.0
    scale = np.array([0.3, 2.0, 1.7], np.float32)[:, None, None]
    pred = (np.where(gt > 0, gt, 20.0) * scale
            * rng.uniform(0.8, 1.2, gt.shape)).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("eigen,median_scale", [(False, False), (False, True),
                                                (True, False), (True, True)])
def test_compute_errors_matches_jax(eigen, median_scale):
    # per image, then the mean over images with a valid pixel: rtol 1e-5
    rng = np.random.default_rng(41)
    gt, pred = _depth_batch(rng)
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
    rng = np.random.default_rng(41)
    angles = rng.uniform(-np.pi, np.pi, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.euler2mat(torch.from_numpy(angles)).numpy(),
                               np.asarray(jax_se3.euler2mat(jnp.asarray(angles))),
                               atol=1e-6)


@pytest.mark.parametrize("gt_mode", ["axis_angle", "euler"])
def test_pose_errors_match_jax(gt_mode):
    # [B, N, 6] snippets, rotations up to ~0.3 rad (the two conventions
    # diverge there); rtol 1e-5
    rng = np.random.default_rng(41)
    pred = np.concatenate([rng.normal(0, 0.1, (4, 2, 3)), rng.normal(0, 0.5, (4, 2, 3))],
                          -1).astype(np.float32)
    gt = (pred + rng.normal(0, 0.05, pred.shape)).astype(np.float32)
    ref = jax_pose_eval.pose_errors(jnp.asarray(pred), jnp.asarray(gt), gt_mode=gt_mode)
    got = pose.pose_errors(torch.from_numpy(pred), torch.from_numpy(gt), gt_mode=gt_mode)
    _assert_metrics_close(got, ref)
    assert float(got["rot_err_deg"]) > 0.1
    if gt_mode == "axis_angle":  # the float64 port is the oracle to rel 1e-12
        assert_rot_err_matches(got["rot_err_deg"], ref["rot_err_deg"], pred, gt, rtol=1e-12)


HEIGHT, WIDTH = 64, 96


def test_pose_forward_matches_jax():
    # the bare pose forward on a normalized NCHW batch (JAX: NHWC) with
    # the same PoseNet weights; atol 1e-5, as the model tests
    rng = np.random.default_rng(41)
    jax_net = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jax_net.init)(jax.random.PRNGKey(4), img,
                                                             [img, img])["params"])
    tgt = rng.normal(size=(2, HEIGHT, WIDTH, 3)).astype(np.float32)
    refs = rng.normal(size=(2, 2, HEIGHT, WIDTH, 3)).astype(np.float32)
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


def _models(rng):
    """Flax DispResNet-18 + PoseNet (plain convs) variables with random
    BatchNorm statistics, as a JAX TrainState, and the port's models with
    the same weights."""
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
    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(state_dict_from_jax(params["depth"], stats, "DispResNet"))
    pose_net = build_model("PoseNet", device="cpu")
    pose_net.load_state_dict(state_dict_from_jax(params["pose"], {}, "PoseNet"))
    return jax_depth, jax_pose, state, depth, pose_net


def test_eval_step_with_eigen_protocol_and_pose_metrics_matches_jax():
    # DispResNet-18 + PoseNet (plain convs) with the same weights, one
    # synthetic batch with groundtruth and oxts, loss_mode 'mean' (the
    # default): the loss at rel 1e-4 (the eval step's tolerance), every
    # pose and depth metric at rel 1e-4 (the depth map itself agrees to
    # rel 1e-4), and the same metric names. The rotation error (float64 in
    # the port, fp32 in JAX) is held against the float64 oracle on JAX's
    # poses: the port's at rel 1e-5, JAX's within its fp32 rounding
    jax_depth, jax_pose, state, depth, pose_net = _models(np.random.default_rng(0))
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=3,
                                         uint8_images=True).batches())
    jax_step = jax_make_eval_step(jax_depth, jax_pose, warp_impl="gather",
                                  eval_protocol="eigen", pose_metrics=True)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, _ = jax_step(state, jax_batch)
    jax_poses = jax_pose_eval.pose_forward(jax_pose, state.params, state.batch_stats,
                                           jax_normalize(jax_batch))

    step = make_eval_step(depth, pose_net, eval_protocol="eigen", pose_metrics=True,
                          device="cpu")
    got, _ = step(batch)
    assert sorted(got) == sorted(["loss", "pose_ate", "pose_ate_unscaled",
                                  "pose_rot_err_deg", "pose_scale", *metrics.METRICS])
    assert all(np.isfinite(float(v)) for v in got.values())
    assert_rot_err_matches(got.pop("pose_rot_err_deg"), ref.pop("pose_rot_err_deg"),
                           jax_poses, batch["oxts"], rtol=1e-5)
    _assert_metrics_close(got, ref, rtol=1e-4, atol=1e-6)


def _semi_batch():
    # OXTS poses at a pose net's scale (a 0.3 m baseline would push every
    # sample out of frame at a fresh disparity head's ~0.2 m depths)
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=4,
                                         uint8_images=True).batches())
    batch["oxts"] = (np.random.default_rng(7).normal(size=(2, 2, 6))
                     * np.array([0.005] * 3 + [0.03] * 3)).astype(np.float32)
    return batch


def test_semi_supervised_eval_step_matches_jax():
    # semi_sup_pose: the loss warps with the batch's OXTS poses (rel 1e-4
    # as above); the pose metrics compare the oxts with themselves, so the
    # ATEs are 0 up to rounding and the scale 1. The rotation error is not
    # 0: the 1e-7 angle regularizer leaves R R^T short of I by ~1e-9 in
    # the trace, an angle of ~3e-3 deg; the port's float64 value is the
    # oracle's to rel 1e-6 (a float64 ulp of that trace is rel ~1e-7 of
    # the angle), JAX's fp32 value is noise within its rounding bound
    jax_depth, jax_pose, state, depth, pose_net = _models(np.random.default_rng(1))
    batch = _semi_batch()
    ref, _ = jax_make_eval_step(jax_depth, jax_pose, warp_impl="gather", semi_sup_pose=True,
                                loss_mode="min", pose_metrics=True)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_eval_step(depth, pose_net, loss_mode="min", pose_metrics=True,
                          semi_sup_pose=True, device="cpu")
    got, _ = step(batch)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-4)
    plain, _ = make_eval_step(depth, pose_net, loss_mode="min", device="cpu")(batch)
    assert float(plain["loss"]) != float(got["loss"])
    for key in ("pose_ate", "pose_ate_unscaled"):
        assert abs(float(got[key])) < 1e-6 and abs(float(ref[key])) < 1e-6, key
    np.testing.assert_allclose(float(got["pose_scale"]), 1.0, rtol=1e-5)
    assert_rot_err_matches(got["pose_rot_err_deg"], ref["pose_rot_err_deg"],
                           batch["oxts"], batch["oxts"], rtol=1e-6)


@pytest.mark.parametrize("semi_sup_pose", [False, True])
def test_pose_eval_step_matches_jax(semi_sup_pose):
    # the pose-only surface (make_pose_eval_step) on a uint8 host batch:
    # rel 1e-4 with the pose net, the rotation error (rel 1e-5) against the float64
    # oracle on JAX's poses as in the eval step; with semi_sup_pose the
    # oxts against themselves (the ATEs 0 up to rounding, the rotation
    # error as in test_semi_supervised_eval_step_matches_jax)
    _, jax_pose, state, _, pose_net = _models(np.random.default_rng(2))
    batch = _semi_batch()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax_pose_eval.make_pose_eval_step(jax_pose, semi_sup_pose=semi_sup_pose)(
        state, jax_batch)
    got = pose.make_pose_eval_step(pose_net, semi_sup_pose=semi_sup_pose, device="cpu")(batch)
    assert sorted(got) == ["ate", "ate_unscaled", "rot_err_deg", "scale"]
    rot, ref_rot = got.pop("rot_err_deg"), ref.pop("rot_err_deg")
    if semi_sup_pose:
        for key in ("ate", "ate_unscaled"):
            assert abs(float(got[key])) < 1e-6, key
        assert_rot_err_matches(rot, ref_rot, batch["oxts"], batch["oxts"], rtol=1e-6)
    else:
        jax_poses = jax_pose_eval.pose_forward(jax_pose, state.params, state.batch_stats,
                                               jax_normalize(jax_batch))
        assert_rot_err_matches(rot, ref_rot, jax_poses, batch["oxts"], rtol=1e-5)
        _assert_metrics_close(got, ref, rtol=1e-4, atol=1e-6)
        assert float(got["ate"]) > 1e-3
