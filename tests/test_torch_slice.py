"""Port parity for the slice as a whole: the validation step and the
pseudo-LiDAR serve pipeline, driven through their entry points with the
same weights and the same inputs in both packages."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.data.synthetic import (
    SyntheticTripletDataset as JaxSyntheticTripletDataset,
)
from unsupervised_pseuso_lidar_tpu.geometry.warp import disp_to_depth as jax_disp_to_depth
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.pseudolidar.pipeline import (
    DepthToPointCloudPipeline as JaxPipeline,
)
from unsupervised_pseuso_lidar_tpu.pseudolidar.projector import PseudoLiDAR as JaxPseudoLiDAR
from unsupervised_pseuso_lidar_tpu.train.trainer import TrainState
from unsupervised_pseuso_lidar_tpu.train.trainer import make_eval_step as jax_make_eval_step
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_fn
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import DepthToPointCloudPipeline
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import make_eval_step
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import normalize_image
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
HEIGHT, WIDTH = 64, 96


@pytest.fixture(scope="module")
def models():
    """Flax DispResNet-18 + PoseNet (plain convs, see test_torch_models)
    with non-trivial BatchNorm statistics, and the port's models holding
    the same weights."""
    rng = np.random.default_rng(0)
    jax_depth = jax_build_model("DispResNet")
    jax_pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    dv = jax.jit(partial(jax_depth.init, train=False))(jax.random.PRNGKey(0), img)
    pv = jax.jit(jax_pose.init)(jax.random.PRNGKey(1), img, [img, img])
    params = {
        "depth": jax.tree.map(np.asarray, dv["params"]),
        "pose": jax.tree.map(np.asarray, pv["params"]),
    }
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        jax.tree.map(np.asarray, dv["batch_stats"]),
    )
    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(state_dict_from_jax(params["depth"], stats, "DispResNet"))
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(state_dict_from_jax(params["pose"], {}, "PoseNet"))
    state = TrainState(step=0, params=params,
                       batch_stats={"depth": stats, "pose": {}}, opt_state=None)
    return jax_depth, jax_pose, state, depth, pose


def test_synthetic_batches_match_jax():
    ours = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=4,
                                        uint8_images=True).batches())
    ref = next(JaxSyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=4,
                                          uint8_images=True).batches())
    assert sorted(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_eval_step_matches_jax(models):
    # loss_mode='min', depth_norm, bidirectional automask, exact warp, fp32
    # models; uint8 images normalized on the device. The loss is a mean of
    # per-pixel minima over SSIM maps: rel 1e-4; depth rel 1e-4
    jax_depth, jax_pose, state, depth, pose = models
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=1,
                                         uint8_images=True).batches())
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()
                 if k not in ("groundtruth", "oxts")}
    jax_step = jax_make_eval_step(jax_depth, jax_pose, loss_mode="min",
                                  warp_impl="gather", depth_norm=True)
    ref_metrics, ref_depth = jax_step(state, jax_batch)

    step = make_eval_step(depth, pose, loss_mode="min", depth_norm=True,
                          device="cpu")
    # the same inputs as the JAX step: no groundtruth, so no depth metrics
    # (tests/test_torch_eval.py compares those)
    metrics, depth_pred = step({k: v for k, v in batch.items()
                                if k not in ("groundtruth", "oxts")})
    assert sorted(metrics) == ["loss"]
    ref_loss = float(ref_metrics["loss"])
    assert np.isfinite(ref_loss) and ref_loss > 0
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-4)
    assert depth_pred.shape == (2, HEIGHT, WIDTH)
    np.testing.assert_allclose(depth_pred.numpy(), np.asarray(ref_depth), rtol=1e-4)


def _write_calib(path):
    # a small camera for the 64x96 frames (baseline terms included), the
    # real KITTI velodyne->camera rotation
    path.mkdir()
    (path / "calib_cam_to_cam.txt").write_text(
        "K_02: 100 0 48 0 100 32 0 0 1\n"
        "P_rect_02: 100 0 48 0.5 0 100 32 0.01 0 0 1 0\n"
        "R_rect_02: 1 0 0 0 1 0 0 0 1\n"
    )
    (path / "calib_velo_to_cam.txt").write_text(
        "R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 "
        "7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02\n"
        "T: -4.069766e-03 -7.631618e-02 -2.717806e-01\n"
    )
    (path / "calib_imu_to_velo.txt").write_text("R: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n")
    return str(path)


def test_pipeline_process_matches_jax(models, tmp_path):
    # depth rel 1e-4; valid masks may differ only where a point sits on the
    # crop boundary within rounding (< 0.1% of pixels); points atol 1e-3 m
    jax_depth, _, state, depth, _ = models
    calib = _write_calib(tmp_path / "calib")
    batch = next(SyntheticTripletDataset(1, 1, HEIGHT, WIDTH, seed=2).batches())
    frame = normalize_image(batch["tgt"][0]).astype(np.float32)

    variables = {"params": state.params["depth"],
                 "batch_stats": state.batch_stats["depth"]}

    def jax_depth_fn(v, img):
        return jax_disp_to_depth(jax_depth.apply(v, img, train=False)[0][..., 0])

    jax_pipe = JaxPipeline(jax_depth_fn, JaxPseudoLiDAR(calib),
                           depth_fn_args=(variables,))
    ref = jax_pipe.process(frame, frame_index=3)

    pipe = DepthToPointCloudPipeline(
        make_depth_fn(depth), PseudoLiDAR(calib, device="cpu"), device="cpu"
    )
    got = pipe.process(frame, frame_index=3)
    assert got.frame_index == 3 and got.depth.shape == (HEIGHT, WIDTH)
    np.testing.assert_allclose(got.depth, ref.depth, rtol=1e-4)

    ref_pts, ref_valid = (np.asarray(a[0]) for a in
                          jax_pipe.projector.project_batch(ref.depth[None]))
    pts, valid = (a[0].numpy() for a in
                  pipe.projector.project_batch(torch.from_numpy(got.depth[None])))
    assert valid.any()
    assert np.mean(valid != ref_valid) < 1e-3
    both = valid & ref_valid
    np.testing.assert_allclose(pts[both], ref_pts[both], atol=1e-3)
    np.testing.assert_array_equal(got.points, pts[valid])


def test_pipeline_streams_and_batches(models, tmp_path):
    # run() processes every frame of a source when the queue holds them
    # all; process_batch gives one result per camera, equal to process()
    _, _, _, depth, _ = models
    pipe = DepthToPointCloudPipeline(
        make_depth_fn(depth),
        PseudoLiDAR(_write_calib(tmp_path / "calib"), device="cpu"), device="cpu",
    )
    rng = np.random.default_rng(9)
    frames = [rng.normal(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
              for _ in range(3)]
    results = []
    assert pipe.run(iter(frames), results.append, queue_size=8) == 3
    assert [r.frame_index for r in results] == [0, 1, 2]
    multi = pipe.process_batch(np.stack(frames[:2]), frame_index=5)
    assert [r.stream_index for r in multi] == [0, 1]
    for r, frame in zip(multi, frames[:2]):
        single = pipe.process(frame)
        np.testing.assert_allclose(r.depth, single.depth, rtol=1e-5)
        assert r.points.shape[1] == 4
