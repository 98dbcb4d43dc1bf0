"""Port parity for the serving stack: FileImageSource, the streaming loops
(run, run_multi), save_cloud, the disparity mappings, load_serving_weights,
cli.pipeline, cli.inference and the ROS adapter, against the JAX package
on the same files and the same weights.

The models are test_torch_slice's (DispResNet-18 at 64x96 with the same
weights in both packages). The CLIs run over tests/test_data.py's
mini-KITTI drive, its frames resized to 64x96, with those weights written
as a reference-schema .pth that both packages' CLIs load.
"""

import json
import os
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_data import DATE, DRIVE, NUM_FRAMES, mini_kitti  # noqa: F401
from tests.test_torch_slice import HEIGHT, WIDTH, _write_calib, models  # noqa: F401
from unsupervised_pseuso_lidar_tpu.cli import inference as jax_inference_cli
from unsupervised_pseuso_lidar_tpu.cli import pipeline as jax_pipeline_cli
from unsupervised_pseuso_lidar_tpu.geometry import oxts as jax_oxts
from unsupervised_pseuso_lidar_tpu.geometry import warp as jax_warp
from unsupervised_pseuso_lidar_tpu.pseudolidar import pipeline as jax_pipeline
from unsupervised_pseuso_lidar_tpu.pseudolidar import projector as jax_projector
from unsupervised_pseuso_lidar_tpu_torch.cli import inference as inference_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import pipeline as pipeline_cli
from unsupervised_pseuso_lidar_tpu_torch.geometry import warp
from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.geometry.oxts import load_velo_scan
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_fn
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import (
    DepthToPointCloudPipeline,
    FileImageSource,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR, save_cloud
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_reference_checkpoint,
    load_serving_weights,
)
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import create_train_state

torch.set_num_threads(1)
RNG = np.random.default_rng(61)
# the serve tolerances of test_torch_slice: depth rel 1e-4; valid masks
# apart only where a point sits on the crop boundary (< 0.1 % of pixels);
# points atol 1e-3 m
DEPTH_RTOL, MASK_SHARE, POINTS_ATOL = 1e-4, 1e-3, 1e-3


def _frames_dir(mini_kitti):  # noqa: F811
    return os.path.join(mini_kitti["kitti"], DATE, DRIVE, "image_02", "data")


def test_file_image_source_matches_jax(mini_kitti):  # noqa: F811
    # the same bytes, normalized or not, resized or not; at rate_hz the
    # frames come on a time.monotonic schedule of 1 / rate_hz
    image_dir = _frames_dir(mini_kitti)
    for kwargs in ({"size_hw": (HEIGHT, WIDTH)}, {"normalize": False}):
        ours = list(FileImageSource(image_dir, **kwargs))
        theirs = list(jax_pipeline.FileImageSource(image_dir, **kwargs))
        assert len(ours) == len(theirs) == NUM_FRAMES
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    t0 = time.monotonic()
    assert len(list(FileImageSource(image_dir, rate_hz=200.0))) == NUM_FRAMES
    assert time.monotonic() - t0 >= NUM_FRAMES / 200.0
    with pytest.raises(FileNotFoundError):
        FileImageSource(os.path.dirname(image_dir))


def _pipeline(depth, tmp_path):
    return DepthToPointCloudPipeline(make_depth_fn(depth), PseudoLiDAR(
        _write_calib(tmp_path / "calib"), device="cpu"), device="cpu")


def test_run_multi_equals_process_per_stream(models, tmp_path):  # noqa: F811
    # 3 cameras x 2 rig steps: one batch-3 forward a step, one result per
    # camera, each equal to process() of its frame; a fourth camera with
    # one frame stops the rig after one step
    _, _, _, depth, _ = models
    pipe = _pipeline(depth, tmp_path)
    frames = RNG.normal(size=(3, 2, HEIGHT, WIDTH, 3)).astype(np.float32)
    results = []
    assert pipe.run_multi([iter(cam) for cam in frames], results.append, queue_size=8) == 2
    assert [(r.frame_index, r.stream_index) for r in results] == [
        (i, s) for i in range(2) for s in range(3)]
    for r in results:
        single = pipe.process(frames[r.stream_index, r.frame_index], r.frame_index)
        np.testing.assert_allclose(r.depth, single.depth, rtol=1e-6)
        np.testing.assert_allclose(r.points, single.points, rtol=1e-6, atol=1e-6)
    short = [iter(cam) for cam in frames] + [iter(frames[0, :1])]
    assert pipe.run_multi(short, lambda r: None, queue_size=8) == 1


def test_a_raising_source_re_raises_in_run_and_run_multi(models, tmp_path):  # noqa: F811
    # the loop ends with the source's exception instead of hanging the
    # consumer; the good frame before it is still processed
    _, _, _, depth, _ = models
    pipe = _pipeline(depth, tmp_path)

    def bad_source():
        yield np.zeros((HEIGHT, WIDTH, 3), np.float32)
        raise RuntimeError("corrupt frame")

    seen = []
    with pytest.raises(RuntimeError, match="corrupt frame"):
        pipe.run(bad_source(), seen.append, queue_size=8)
    assert len(seen) == 1
    with pytest.raises(RuntimeError, match="corrupt frame"):
        pipe.run_multi([bad_source(), bad_source()], seen.append, queue_size=8)
    assert len(seen) == 3


def test_latest_wins_queue_drops_stale_frames(tmp_path):
    # queue_size 1 and a consumer busy until the source has yielded every
    # frame: the frames queued behind the one in flight are replaced by the
    # freshest, so at most two are processed (one if the feed ran ahead of
    # the consumer's first get), the last one last
    frames = [np.zeros((HEIGHT, WIDTH, 3), np.float32)] * 6
    drained = threading.Event()

    def source():
        yield from frames
        drained.set()

    def depth_fn(img):
        assert drained.wait(timeout=60)
        return torch.full(img.shape[:3], 12.0)

    pipe = DepthToPointCloudPipeline(depth_fn, PseudoLiDAR(
        _write_calib(tmp_path / "calib"), device="cpu"), device="cpu")
    results = []
    assert pipe.run(source(), results.append, queue_size=1) == len(results) <= 2
    assert results[-1].frame_index == len(frames) - 1


def test_save_cloud_round_trips_through_both_packages(tmp_path):
    # .bin: raw float32 rows that both velodyne readers load; .npy: numpy;
    # the two packages write the same bytes
    cloud = RNG.normal(size=(57, 4)).astype(np.float32)
    for ext in ("bin", "npy"):
        ours, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
        save_cloud(ours, cloud)
        jax_projector.save_cloud(theirs, cloud)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        read = (load_velo_scan, jax_oxts.load_velo_scan) if ext == "bin" else (np.load,)
        for reader in read:
            np.testing.assert_array_equal(reader(ours), cloud)


def test_disparity_mappings_match_jax():
    disp = RNG.uniform(0.0, 1.0, (2, 5, 7)).astype(np.float32)
    depth = RNG.uniform(0.1, 80.0, (2, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(warp.depth_to_disp(torch.from_numpy(depth)).numpy(),
                               np.asarray(jax_warp.depth_to_disp(jnp.asarray(depth))),
                               rtol=1e-6)
    for kwargs in ({}, {"min_depth": 0.5, "max_depth": 80.0}):
        got = warp.disp_to_depth_ranged(torch.from_numpy(disp), **kwargs)
        ref = jax_warp.disp_to_depth_ranged(jnp.asarray(disp), **kwargs)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    back = warp.disp_to_depth(warp.depth_to_disp(torch.from_numpy(depth)))
    np.testing.assert_allclose(back.numpy(), depth, rtol=1e-5)


# --------------------------------------------------------------------------
# load_serving_weights
# --------------------------------------------------------------------------


def _state(tmp_path, seed=3, **action):
    config = Config.from_dict({
        "model": {"name": "serve", "depth": {"name": "DispResNet"}, "pose": {"name": "PoseNet"}},
        "datasets": {"augmentation": {"image_height": HEIGHT, "image_width": WIDTH}},
        "action": {"checkpoint_dir": str(tmp_path / "ckpt"), **action},
    })
    return config, create_train_state(config, torch.Generator().manual_seed(seed), device="cpu")


def _equal(model, state_dict):
    own = model.state_dict()
    return sorted(own) == sorted(state_dict) and all(
        torch.equal(own[k], state_dict[k]) for k in own)


def test_load_serving_weights_takes_every_blob_kind(tmp_path, capsys):
    config, state = _state(tmp_path)
    _, trained = _state(tmp_path, seed=4)
    depth_sd = trained.depth_model.state_dict()
    pose_sd = trained.pose_model.state_dict()
    pose_init = {k: v.clone() for k, v in state.pose_model.state_dict().items()}
    decoder_init = {k: v.clone() for k, v in state.depth_model.state_dict().items()
                    if k.startswith("decoder.")}

    # a reference checkpoint: depth and pose
    ref = str(tmp_path / "ref.pth")
    export_reference_checkpoint(trained.depth_model, trained.pose_model, ref)
    assert load_serving_weights(config, state, torch_checkpoint=ref) == ref
    assert _equal(state.depth_model, depth_sd) and _equal(state.pose_model, pose_sd)

    # a bare DispResNet state dict (.pth, and as .npz, with DataParallel's
    # prefix): the depth net only
    for path in (str(tmp_path / "bare.pth"), str(tmp_path / "bare.npz")):
        config, state = _state(tmp_path)
        if path.endswith(".pth"):
            torch.save(depth_sd, path)
        else:
            np.savez(path, **{f"module.{k}": v.numpy() for k, v in depth_sd.items()})
        assert load_serving_weights(config, state, torch_checkpoint=path) == path
        assert _equal(state.depth_model, depth_sd) and _equal(state.pose_model, pose_init)

    # a torchvision resnet18 state dict: the encoder; the decoder stays
    config, state = _state(tmp_path)
    tv = {k[len("encoder.encoder."):]: v for k, v in depth_sd.items()
          if k.startswith("encoder.encoder.")}
    tv.update({"fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000)})
    torch.save(tv, str(tmp_path / "resnet18.pth"))
    load_serving_weights(config, state, torch_checkpoint=str(tmp_path / "resnet18.pth"))
    own = state.depth_model.state_dict()
    assert all(torch.equal(own[f"encoder.encoder.{k}"], v) for k, v in tv.items()
               if not k.startswith("fc."))
    assert all(torch.equal(own[k], v) for k, v in decoder_init.items())

    # pose weights of another schema: a warning, the pose net stays
    config, state = _state(tmp_path)
    torch.save({"dpth_mdl_state_dict": depth_sd, "pose_mdl_state_dict": {"fc.weight": torch.zeros(2)}},
               str(tmp_path / "other_pose.pth"))
    capsys.readouterr()
    load_serving_weights(config, state, torch_checkpoint=str(tmp_path / "other_pose.pth"))
    assert "pose stays at random init" in capsys.readouterr().out
    assert _equal(state.depth_model, depth_sd) and _equal(state.pose_model, pose_init)


def test_load_serving_weights_resolves_checkpoint_directories(tmp_path, capsys):
    config, trained = _state(tmp_path, seed=4)
    directory = str(tmp_path / "ckpt" / "serve")
    CheckpointManager(directory).save(trained, 0)
    # an explicit directory, and the config's when from_scratch is False
    for kwargs, action in (({"checkpoint": directory}, {}), ({}, {"from_scratch": False})):
        config, state = _state(tmp_path, **action)
        assert load_serving_weights(config, state, **kwargs) == directory
        assert _equal(state.depth_model, trained.depth_model.state_dict())
    # nothing to restore: an explicit directory raises, the config's warns
    config, state = _state(tmp_path, from_scratch=False)
    with pytest.raises(FileNotFoundError, match="no restorable state"):
        load_serving_weights(config, state, checkpoint=str(tmp_path / "empty"))
    config, state = _state(tmp_path, from_scratch=False, checkpoint_dir=str(tmp_path / "none"))
    capsys.readouterr()
    assert load_serving_weights(config, state) == "init (untrained)"
    assert "no checkpoint under" in capsys.readouterr().out
    config, state = _state(tmp_path)
    assert load_serving_weights(config, state, checkpoint=None) == "init (untrained)"


# --------------------------------------------------------------------------
# the CLIs against JAX's
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):  # noqa: F811
    """A config (DispResNet + PoseNet at 64x96, fp32) and the fixture's
    weights as a reference-schema .pth, readable by both packages."""
    _, _, _, depth, pose = models
    root = tmp_path_factory.mktemp("served")
    pth = str(root / "weights.pth")
    export_reference_checkpoint(depth, pose, pth)
    raw = {"model": {"name": "served", "depth": {"name": "DispResNet"},
                     "pose": {"name": "PoseNet"}},
           "datasets": {"augmentation": {"image_height": HEIGHT, "image_width": WIDTH}},
           "action": {"checkpoint_dir": str(root / "ckpt")}}
    config = root / "served.yaml"
    config.write_text(yaml.safe_dump(raw))
    return str(config), pth


def _pixels(cloud, calib):
    """The image pixel (row-major index) each point of a cloud came from:
    its velodyne point projected back through T_velo_cam and P_rect_02."""
    cam = np.c_[cloud[:, :3], np.ones(len(cloud))] @ calib.T_velo_cam.T
    # P_rect_02 (x, y, depth, 1) = depth (u, v, ·): the projector's inverse
    uv = np.rint((cam @ calib.P.T)[:, :2] / cam[:, 2:3]).astype(int)
    return uv[:, 1] * WIDTH + uv[:, 0]


def _assert_clouds_match(ours, theirs, calib):
    a, b = _pixels(ours, calib), _pixels(theirs, calib)
    assert len(np.unique(a)) == len(a) and len(a) > 0
    assert len(np.setxor1d(a, b)) <= MASK_SHARE * HEIGHT * WIDTH + 1
    common, ia, ib = np.intersect1d(a, b, return_indices=True)
    assert len(common) > 0
    np.testing.assert_allclose(ours[ia], theirs[ib], atol=POINTS_ATOL)


def test_pipeline_cli_matches_jax(mini_kitti, served, tmp_path, capsys):  # noqa: F811
    # a 2-camera rig (the drive twice), lossless queue, .bin clouds: the
    # same file names and stats keys as JAX's CLI, and the same clouds;
    # one camera gives cloud_<frame>.npy files
    config, pth = served
    image_dir = _frames_dir(mini_kitti)
    calib = os.path.join(mini_kitti["kitti"], DATE)
    common = ["--images", image_dir, image_dir, "--calib", calib, "--config", config,
              "--torch-checkpoint", pth, "--height", str(HEIGHT), "--width", str(WIDTH),
              "--max-frames", "2", "--queue-size", "8", "--format", "bin"]
    stats = pipeline_cli.main([*common, "--save-dir", str(tmp_path / "port"),
                               "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_pipeline_cli.main([*common, "--save-dir", str(tmp_path / "jax")])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats == printed and sorted(stats) == sorted(ref)
    assert stats["frames"] == ref["frames"] == 2 and stats["streams"] == 2
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        f"cloud_cam{c}_{i:06d}.bin" for c in range(2) for i in range(2)]
    cal = Calibration(calib)
    for name in files:
        _assert_clouds_match(load_velo_scan(str(tmp_path / "port" / name)),
                             load_velo_scan(str(tmp_path / "jax" / name)), cal)

    argfile = tmp_path / "args.txt"
    argfile.write_text(f"--images {image_dir}\n--calib {calib}\n--config {config}\n"
                       f"--height {HEIGHT}\n--width {WIDTH}\n--queue-size 8\n--device cpu\n")
    single = pipeline_cli.main([f"@{argfile}", "--save-dir", str(tmp_path / "one")])
    assert single["frames"] == NUM_FRAMES and single["streams"] == 1
    assert sorted(os.listdir(tmp_path / "one")) == [f"cloud_{i:06d}.npy"
                                                    for i in range(NUM_FRAMES)]


@pytest.mark.parametrize("argv,error,match", [
    (["--checkpoint", "ckpt"], SystemExit, "need --config"),
])
def test_pipeline_cli_refuses(mini_kitti, argv, error, match):  # noqa: F811
    with pytest.raises(error, match=match):
        pipeline_cli.main(["--images", _frames_dir(mini_kitti), "--calib",
                           os.path.join(mini_kitti["kitti"], DATE), "--device", "cpu", *argv])


def test_pipeline_cli_serves_stndispnet_like_jax(mini_kitti, tmp_path, capsys):  # noqa: F811
    # a StnDispNet config with its weights as a reference .pth: the same
    # clouds as JAX's CLI from the same file (tests/test_torch_bts.py holds
    # BtsModel to JAX's CLI the same way); --model without --config builds
    # each of the JAX CLI's choices at its seeded init
    depth = build_model("StnDispNet", torch.Generator().manual_seed(4), device="cpu")
    pose = build_model("PoseNet", torch.Generator().manual_seed(5), device="cpu")
    pth = str(tmp_path / "stn.pth")
    export_reference_checkpoint(depth, pose, pth)
    raw = {"model": {"name": "stn", "depth": {"name": "StnDispNet"}, "pose": {"name": "PoseNet"}},
           "datasets": {"augmentation": {"image_height": HEIGHT, "image_width": WIDTH}},
           "action": {"checkpoint_dir": str(tmp_path / "ckpt")}}
    config = tmp_path / "stn.yaml"
    config.write_text(yaml.safe_dump(raw))
    calib = os.path.join(mini_kitti["kitti"], DATE)
    common = ["--images", _frames_dir(mini_kitti), "--calib", calib, "--config", str(config),
              "--torch-checkpoint", pth, "--height", str(HEIGHT), "--width", str(WIDTH),
              "--max-frames", "2", "--queue-size", "8", "--format", "bin"]
    pipeline_cli.main([*common, "--save-dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_pipeline_cli.main([*common, "--save-dir", str(tmp_path / "jax")])
    assert capsys.readouterr().out.count("serving StnDispNet weights from") == 2
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [f"cloud_{i:06d}.bin"
                                                              for i in range(2)]
    cal = Calibration(calib)
    for name in files:
        _assert_clouds_match(load_velo_scan(str(tmp_path / "port" / name)),
                             load_velo_scan(str(tmp_path / "jax" / name)), cal)
    for model in ("DispNetS", "StnDispNet", "BtsModel"):
        stats = pipeline_cli.main(["--images", _frames_dir(mini_kitti), "--calib", calib,
                                   "--model", model, "--height", str(HEIGHT), "--width",
                                   str(WIDTH), "--max-frames", "1", "--device", "cpu"])
        assert stats["frames"] == 1


def test_inference_cli_matches_jax(mini_kitti, served, tmp_path):  # noqa: F811
    # depth at rel 1e-4 against JAX's CLI on the same frame and .pth; the
    # .bin cloud as PseudoLiDAR.project_PL gives it
    config, pth = served
    image = os.path.join(_frames_dir(mini_kitti), "0000000001.png")
    calib = os.path.join(mini_kitti["kitti"], DATE)
    argv = ["--config", config, "--image", image, "--torch-checkpoint", pth,
            "--calib", calib]
    depth = inference_cli.main([*argv, "--output", str(tmp_path / "d.npy"),
                                "--cloud", str(tmp_path / "c.bin"), "--device", "cpu"])
    ref = jax_inference_cli.main([*argv, "--output", str(tmp_path / "j.npy")])
    assert depth.shape == (HEIGHT, WIDTH)
    np.testing.assert_allclose(depth, np.asarray(ref), rtol=DEPTH_RTOL)
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), depth)
    cloud = load_velo_scan(str(tmp_path / "c.bin"))
    np.testing.assert_array_equal(cloud, PseudoLiDAR(calib, device="cpu").project_PL(depth))
    inference_cli.main([*argv[:4], "--output", str(tmp_path / "d.png"), "--device", "cpu"])
    assert os.path.getsize(tmp_path / "d.png") > 0


# --------------------------------------------------------------------------
# the ROS adapter, against stub ROS modules
# --------------------------------------------------------------------------


class _Msg:
    def __init__(self, **fields):
        self.__dict__.update(fields)


@pytest.fixture
def ros_stubs(monkeypatch):
    point_field = type("PointField", (_Msg,), {"FLOAT32": 7})
    published = []

    class Publisher:
        def __init__(self, topic, msg_type, queue_size):
            self.topic = topic

        def publish(self, msg):
            published.append((self.topic, msg))

    subscribed = []
    rospy = types.SimpleNamespace(
        Time=types.SimpleNamespace(now=lambda: "now"), init_node=lambda *a, **k: None,
        Publisher=Publisher, spin=lambda: None,
        Subscriber=lambda topic, msg_type, callback, queue_size: subscribed.append(callback))
    bridge = types.SimpleNamespace(
        imgmsg_to_cv2=lambda msg, desired_encoding: msg.data,
        cv2_to_imgmsg=lambda array: _Msg(data=array))
    modules = {
        "rospy": rospy,
        "sensor_msgs": types.ModuleType("sensor_msgs"),
        "sensor_msgs.msg": types.SimpleNamespace(PointCloud2=_Msg, PointField=point_field,
                                                 Image=_Msg),
        "std_msgs": types.ModuleType("std_msgs"),
        "std_msgs.msg": types.SimpleNamespace(Header=_Msg),
        "cv_bridge": types.SimpleNamespace(CvBridge=lambda: bridge),
    }
    for name, module in modules.items():
        monkeypatch.setitem(sys.modules, name, module)
    return published, subscribed


def test_ros_adapter_publishes_xyzi_clouds(ros_stubs, models, tmp_path):  # noqa: F811
    from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.ros_adapter import (
        RosPseudoLidarNode,
        cloud_to_pointcloud2_msg,
    )

    published, subscribed = ros_stubs
    cloud = RNG.normal(size=(11, 4)).astype(np.float64)
    msg = cloud_to_pointcloud2_msg(cloud, stamp=5)
    assert [f.name for f in msg.fields] == ["x", "y", "z", "i"]
    assert [f.offset for f in msg.fields] == [0, 4, 8, 12]
    assert msg.point_step == 16 and msg.row_step == 16 * 11 and msg.width == 11
    assert msg.height == 1 and not msg.is_bigendian and msg.header.stamp == 5
    assert msg.header.frame_id == "velodyne"
    assert msg.data == cloud.astype(np.float32).tobytes()
    assert cloud_to_pointcloud2_msg(cloud).header.stamp == "now"

    # the node: a camera frame of another size in, a cloud and a depth out
    _, _, _, depth, _ = models
    pipe = _pipeline(depth, tmp_path)
    node = RosPseudoLidarNode(pipe, size_hw=(HEIGHT, WIDTH))
    node.start()
    frame = RNG.integers(0, 256, (HEIGHT + 6, WIDTH + 10, 3)).astype(np.uint8)
    subscribed[0](_Msg(data=frame, header=_Msg(stamp=9)))
    (cloud_topic, cloud_msg), (depth_topic, depth_msg) = published
    assert (cloud_topic, depth_topic) == ("PL/output", "depth/output")
    assert cloud_msg.header.stamp == 9 and depth_msg.data.shape == (HEIGHT, WIDTH)
    points = np.frombuffer(cloud_msg.data, np.float32).reshape(-1, 4)
    assert points.shape[0] == cloud_msg.width > 0
