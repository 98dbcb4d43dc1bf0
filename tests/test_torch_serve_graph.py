"""Serving as one program: DepthToPointCloudPipeline, the pose-only eval
step and cli.odometry through train/graph.StepGraphs, on the CPU.

On the card these run as CUDA graphs (the captured cases of
tests/test_torch_cuda.py and chip_smoke's `serve_graph`). Here the same
protocol runs with StepGraphs(capture=False): the first call of a batch
shape runs eagerly, the later ones run the body on the static buffers
refilled from each input, what a replay reads. That path is held to the
eager port bit for bit, and both to the JAX package's jitted serving
(DepthToPointCloudPipeline, make_pose_eval_step, cli.odometry) from the
same numpy weights, at the tolerances tests/test_torch_serve.py states.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_data import NUM_FRAMES, mini_kitti  # noqa: F401
from tests.test_torch_cli import (  # noqa: F401
    KITTI_HW,
    _kitti_config,
    _save_port_checkpoint,
    jax_weights,
)
from tests.test_torch_eval import _assert_metrics_close, _semi_batch, assert_rot_err_matches
from tests.test_torch_serve import DEPTH_RTOL, MASK_SHARE, POINTS_ATOL
from tests.test_torch_slice import _write_calib
from unsupervised_pseuso_lidar_tpu.cli import odometry as jax_odometry_cli
from unsupervised_pseuso_lidar_tpu.eval import pose as jax_pose_eval
from unsupervised_pseuso_lidar_tpu.geometry.warp import disp_to_depth as jax_disp_to_depth
from unsupervised_pseuso_lidar_tpu.pseudolidar import pipeline as jax_pipeline
from unsupervised_pseuso_lidar_tpu.pseudolidar import projector as jax_projector
from unsupervised_pseuso_lidar_tpu.train import trainer as jax_trainer
from unsupervised_pseuso_lidar_tpu_torch.cli import odometry as odometry_cli
from unsupervised_pseuso_lidar_tpu_torch.eval.pose import make_pose_eval_step
from unsupervised_pseuso_lidar_tpu_torch.geometry.calibration import Calibration
from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import disp_to_depth
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_fn
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.pipeline import DepthToPointCloudPipeline
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
    PseudoLiDAR,
    depth_to_pointcloud,
)
from unsupervised_pseuso_lidar_tpu_torch.train import graph as graph_module
from unsupervised_pseuso_lidar_tpu_torch.train.graph import StepGraphs
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")
HEIGHT, WIDTH = KITTI_HW


@pytest.fixture(scope="module")
def nets(jax_weights):  # noqa: F811
    """test_torch_cli's JAX DispResNet-18 + PoseNet (random BatchNorm
    statistics, a pose head bias) and the port's nets with those weights."""
    jax_depth, jax_pose, state = jax_weights
    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(state_dict_from_jax(state.params["depth"],
                                              state.batch_stats["depth"], "DispResNet"))
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(state_dict_from_jax(state.params["pose"], {}, "PoseNet"))
    return jax_depth, jax_pose, state, depth, pose


def _static(pipeline):
    """The pipeline with its program run as the graph path does on the CPU."""
    assert not pipeline.graphs.graphed  # the CPU's default: eager
    pipeline.graphs = StepGraphs(CPU, capture=False, modules=[pipeline._fused])
    return pipeline


def _pipeline(depth, calib, **kwargs):
    return DepthToPointCloudPipeline(make_depth_fn(depth, **kwargs),
                                     PseudoLiDAR(calib, device="cpu"), device="cpu")


def _frames(seed, count):
    return np.random.default_rng(seed).normal(size=(count, HEIGHT, WIDTH, 3)).astype(np.float32)


def _assert_same(got, want):
    assert (got.frame_index, got.stream_index) == (want.frame_index, want.stream_index)
    assert np.array_equal(got.depth, want.depth)
    assert got.points.shape == want.points.shape and np.array_equal(got.points, want.points)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_the_graph_path_equals_the_eager_pipeline_bit_for_bit(nets, tmp_path, precision):
    # process (3 frames: eager, "capture", "replay"), process_batch at
    # S = 2 (its own batch shape) and run over a lossless queue: depth and
    # compacted clouds equal bit for bit; one buffer set a batch shape
    _, _, _, depth, _ = nets
    calib = _write_calib(tmp_path / "calib")
    eager = _pipeline(depth, calib, precision=precision)
    static = _static(_pipeline(depth, calib, precision=precision))
    frames = _frames(101, 6)
    for i in range(3):
        _assert_same(static.process(frames[i], i), eager.process(frames[i], i))
    for i in range(3):
        got = static.process_batch(frames[i:i + 2], i)
        want = eager.process_batch(frames[i:i + 2], i)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _assert_same(a, b)
    got, want = [], []
    assert static.run(iter(frames), got.append, queue_size=8) == len(frames)
    assert eager.run(iter(frames), want.append, queue_size=8) == len(frames)
    for a, b in zip(got, want):
        _assert_same(a, b)
    assert len(static.graphs.graphs) == 2
    assert all(r.points.shape[0] > 0 for r in got)


def test_the_graph_path_matches_jax_s_jitted_pipeline(nets, tmp_path):
    # JAX's DepthToPointCloudPipeline (one jitted depth + projector program)
    # from the same weights, process and a 2-camera process_batch, 3 calls
    # each on the graph path: depth rel 1e-4; the clouds compared through
    # each side's projection of its own depth (masks apart on < 0.1 % of
    # pixels, points atol 1e-3 m), and the pipeline's cloud that
    # projection's valid points exactly
    jax_depth, _, state, depth, _ = nets
    calib = _write_calib(tmp_path / "calib")
    variables = {"params": state.params["depth"], "batch_stats": state.batch_stats["depth"]}

    def jax_depth_fn(v, img):
        return jax_disp_to_depth(jax_depth.apply(v, img, train=False)[0][..., 0])

    ref_pipe = jax_pipeline.DepthToPointCloudPipeline(
        jax_depth_fn, jax_projector.PseudoLiDAR(calib), depth_fn_args=(variables,))
    pipe = _static(_pipeline(depth, calib))
    frames = _frames(102, 4)
    pairs = []
    for i in range(3):
        pairs.append((pipe.process(frames[i], i), ref_pipe.process(frames[i], i)))
        pairs += zip(pipe.process_batch(frames[i:i + 2], i),
                     ref_pipe.process_batch(frames[i:i + 2], i))
    for got, ref in pairs:
        assert (got.frame_index, got.stream_index) == (ref.frame_index, ref.stream_index)
        np.testing.assert_allclose(got.depth, ref.depth, rtol=DEPTH_RTOL)
        pts, valid = (a[0].numpy() for a in
                      pipe.projector.project_batch(torch.from_numpy(got.depth[None])))
        ref_pts, ref_valid = (np.asarray(a[0]) for a in
                              ref_pipe.projector.project_batch(ref.depth[None]))
        assert valid.any() and np.mean(valid != ref_valid) < MASK_SHARE
        both = valid & ref_valid
        np.testing.assert_allclose(pts[both], ref_pts[both], atol=POINTS_ATOL)
        assert np.array_equal(got.points, pts[valid])


@pytest.mark.parametrize("sparsity,max_high", [(0, 1.0), (3, 0.5)])
def test_depth_to_pointcloud_with_inv_ex_has_inv_s_bits_and_matches_jax(sparsity, max_high,
                                                                        monkeypatch, tmp_path):
    # linalg.inv_ex (no error check that waits for the device) against
    # linalg.inv: the same inverse and the same cloud bit for bit; against
    # JAX's depth_to_pointcloud: valid masks apart on < 0.1 % of pixels,
    # points atol 1e-3 m (the serve tolerances)
    calib = Calibration(_write_calib(tmp_path / "calib"))
    proj = torch.as_tensor(calib.P, dtype=torch.float32)
    velo_to_cam = torch.as_tensor(calib.T_velo_cam, dtype=torch.float32)
    gen = torch.Generator().manual_seed(103)
    depth = torch.rand(2, HEIGHT, WIDTH, generator=gen) * 60.0
    depth[:, :3] = 0.0  # no-return pixels
    assert torch.equal(torch.linalg.inv_ex(velo_to_cam).inverse, torch.linalg.inv(velo_to_cam))
    points, valid = depth_to_pointcloud(depth, proj, velo_to_cam, sparsity=sparsity,
                                        max_high=max_high)
    with monkeypatch.context() as m:
        m.setattr(torch.linalg, "inv_ex",
                  lambda a: types.SimpleNamespace(inverse=torch.linalg.inv(a)))
        inv_points, inv_valid = depth_to_pointcloud(depth, proj, velo_to_cam,
                                                    sparsity=sparsity, max_high=max_high)
    assert torch.equal(points, inv_points) and torch.equal(valid, inv_valid)
    ref_points, ref_valid = (np.asarray(a) for a in jax_projector.depth_to_pointcloud(
        jnp.asarray(depth.numpy()), jnp.asarray(calib.P, jnp.float32),
        jnp.asarray(calib.T_velo_cam, jnp.float32), sparsity=sparsity, max_high=max_high))
    valid = valid.numpy()
    assert valid.any() and np.mean(valid != ref_valid) < MASK_SHARE
    both = valid & ref_valid
    np.testing.assert_allclose(points.numpy()[both], ref_points[both], atol=POINTS_ATOL)


def test_bf16_depth_program_without_the_autocast_cache_has_the_same_bits(nets):
    # DepthProgram runs bf16 autocast with its weight cache off (a CUDA
    # graph would read the cache after the region freed it): on the CPU
    # the same depth, bit for bit, as the model under autocast with the
    # cache on; and not the fp32 depth
    _, _, _, depth, _ = nets
    program = make_depth_fn(depth, precision="bf16")
    img = torch.from_numpy(_frames(104, 2))
    with torch.no_grad():
        got = program(img)
        with torch.autocast("cpu", torch.bfloat16, cache_enabled=True):
            outputs = depth(img.permute(0, 3, 1, 2).contiguous())
        want = disp_to_depth(outputs[0][:, 0].float())
        fp32 = make_depth_fn(depth)(img)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert not torch.equal(got, fp32)


def test_a_weight_reload_in_place_is_served_and_a_replaced_one_raises(nets, tmp_path):
    # weights copied into the live parameters after the capture
    # (load_state_dict, as load_serving_weights does) are what the next
    # frame serves; a parameter replaced by another tensor makes the next
    # call raise until reset(), and then the new one is served
    _, _, _, depth, _ = nets
    calib = _write_calib(tmp_path / "calib")
    model = build_model("DispResNet", torch.Generator().manual_seed(5), device="cpu")
    model.load_state_dict(depth.state_dict())
    pipe = _static(_pipeline(model, calib))
    frames = _frames(105, 3)
    for i in range(2):
        pipe.process(frames[i], i)
    assert len(pipe.graphs.graphs) == 1
    other = build_model("DispResNet", torch.Generator().manual_seed(6), device="cpu")
    model.load_state_dict(other.state_dict())
    _assert_same(pipe.process(frames[2], 2), _pipeline(other, calib).process(frames[2], 2))
    assert len(pipe.graphs.graphs) == 1

    name = next(n for n, _ in model.named_parameters() if n.endswith("weight"))
    owner, leaf = model.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
    setattr(owner, leaf, nn.Parameter(getattr(owner, leaf).detach() * 0.5))
    with pytest.raises(RuntimeError, match="replaced or moved"):
        pipe.process(frames[0])
    pipe.reset()
    assert not pipe.graphs.graphs
    served = [pipe.process(frames[i], i) for i in range(3)]
    reference = _pipeline(model, calib)
    for got in served:
        _assert_same(got, reference.process(frames[got.frame_index], got.frame_index))
    assert len(pipe.graphs.graphs) == 1


@pytest.mark.parametrize("change", ["data", "attribute", "submodule", "buffer"])
def test_step_graphs_refuse_replaced_module_state(change):
    # StepGraphs given the modules its body reads: a parameter's storage
    # swapped (.data), a parameter or buffer registered anew, or a
    # submodule replaced after the capture raises on the next call; reset()
    # takes the modules as they are
    net = nn.Sequential(nn.Linear(3, 2), nn.BatchNorm1d(2)).eval()

    def body(inputs):
        with torch.no_grad():
            return (net(inputs["x"]),)

    graphs = StepGraphs(CPU, capture=False, modules=[net])
    x = torch.ones(4, 3)
    for _ in range(3):
        graphs(body, {"x": x})
    if change == "data":
        net[0].weight.data = net[0].weight.data.clone()
    elif change == "attribute":
        net[0].bias = nn.Parameter(torch.zeros(2))
    elif change == "submodule":
        net[1] = nn.BatchNorm1d(2).eval()
    else:
        net[1].running_var = torch.full((2,), 4.0)
    with pytest.raises(RuntimeError, match="replaced or moved"):
        graphs(body, {"x": x})
    graphs.reset()
    for _ in range(3):
        (got,) = graphs(body, {"x": x})
    assert torch.equal(got, body({"x": x})[0])


@pytest.mark.parametrize("semi_sup_pose", [False, True])
def test_pose_eval_step_graph_path_equals_eager_and_matches_jax(nets, semi_sup_pose):
    # the pose-only step's body (normalize, pose net, pose_errors) on the
    # graph path against the eager step over 3 host batches: every metric
    # bit for bit; and against JAX's jitted make_pose_eval_step as
    # tests/test_torch_eval.py holds it (rel 1e-4; the rotation error
    # against the float64 oracle)
    _, jax_pose, state, _, pose = nets
    step = make_pose_eval_step(pose, semi_sup_pose=semi_sup_pose, device="cpu")
    eager = make_pose_eval_step(pose, semi_sup_pose=semi_sup_pose, device="cpu", graph=False)
    assert not step.graphs.graphed and not eager.graphs.graphed
    step.graphs = StepGraphs(CPU, capture=False, modules=[pose])
    batch = _semi_batch()
    rng = np.random.default_rng(106)
    for _ in range(3):
        batch = dict(batch, oxts=(rng.normal(size=(2, 2, 6)) * np.array([0.005] * 3 + [0.03] * 3)
                                  ).astype(np.float32))
        got, want = step(batch), eager(batch)
        assert sorted(got) == sorted(want) == ["ate", "ate_unscaled", "rot_err_deg", "scale"]
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert len(step.graphs.graphs) == 1
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax_pose_eval.make_pose_eval_step(jax_pose, semi_sup_pose=semi_sup_pose)(
        state, jax_batch)
    rot, ref_rot = got.pop("rot_err_deg"), ref.pop("rot_err_deg")
    if semi_sup_pose:
        assert all(abs(float(got[k])) < 1e-6 for k in ("ate", "ate_unscaled"))
        assert_rot_err_matches(rot, ref_rot, batch["oxts"], batch["oxts"], rtol=1e-6)
    else:
        jax_poses = jax_pose_eval.pose_forward(jax_pose, state.params, state.batch_stats,
                                               jax_trainer.normalize_uint8_batch(jax_batch))
        assert_rot_err_matches(rot, ref_rot, jax_poses, batch["oxts"], rtol=1e-5)
        _assert_metrics_close(got, ref, rtol=1e-4, atol=1e-6)


def test_graph_true_is_refused_on_the_cpu_for_serving(nets, tmp_path):
    _, _, _, depth, pose = nets
    with pytest.raises(ValueError, match="needs a CUDA device"):
        DepthToPointCloudPipeline(make_depth_fn(depth), PseudoLiDAR(
            _write_calib(tmp_path / "calib"), device="cpu"), device="cpu", graph=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_pose_eval_step(pose, device="cpu", graph=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        odometry_cli.main(["--config", "configs/basic_config.yaml", "--out", "unused.txt",
                           "--device", "cpu"], graph=True)


def test_odometry_pads_the_last_batch_and_matches_jax_s_cli(mini_kitti, tmp_path,  # noqa: F811
                                                           jax_weights, monkeypatch):  # noqa: F811
    # 5 windows in batches of 3: the last batch padded with its last
    # window and the results trimmed, as JAX's CLI does. The graph path (one
    # buffer set for the drive) writes the eager path's trajectory byte for
    # byte, and JAX's cli.odometry (its Trainer given the same weights)
    # the same trajectory to atol 1e-5 (test_torch_cli's bound)
    path, raw = _kitti_config(tmp_path, mini_kitti, batch_size=3)
    _save_port_checkpoint(raw, jax_weights)
    eager_out, graph_out, jax_out = (tmp_path / f"{n}.txt" for n in ("eager", "graph", "jax"))
    eager = odometry_cli.main(["--config", path, "--out", str(eager_out), "--device", "cpu"])
    made = []

    class Recorded(StepGraphs):
        def __init__(self, device, **kwargs):
            super().__init__(device, capture=False, **kwargs)
            made.append(self)

    with monkeypatch.context() as m:
        m.setattr(graph_module, "StepGraphs", Recorded)
        graphed = odometry_cli.main(["--config", path, "--out", str(graph_out),
                                     "--device", "cpu"])
    assert len(made) == 1 and len(made[0].graphs) == 1
    assert graph_out.read_bytes() == eager_out.read_bytes()
    assert graphed == eager and eager["frames"] == NUM_FRAMES
    jax_depth, jax_pose, state = jax_weights
    with monkeypatch.context() as m:
        m.setattr(jax_trainer, "Trainer",
                  lambda config, dataset=None: types.SimpleNamespace(pose_model=jax_pose,
                                                                     state=state))
        jax_metrics = jax_odometry_cli.main(["--config", path, "--out", str(jax_out)])

    def rows(path):
        return np.array([[float(x) for x in line.split()] for line in
                         path.read_text().splitlines()])

    got, ref = rows(eager_out), rows(jax_out)
    assert got.shape == ref.shape == (NUM_FRAMES, 12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(got[-1] - got[0]).max() > 1e-3
    assert jax_metrics["frames"] == eager["frames"]


class _RampDepth(nn.Module):
    """[B, H, W, 3] -> [B, H, W] depth from 5 to 35 m, the image's mean
    added: a depth function without a network."""

    def forward(self, img):
        ramp = torch.linspace(5.0, 35.0, img.shape[2], device=img.device)
        return ramp.expand(img.shape[:3]) + img.mean(-1)


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graph_path"])
@pytest.mark.parametrize("cameras", [1, 2], ids=["process", "process_batch"])
def test_each_frame_records_its_serving_spans(tmp_path, cameras, graphs):
    # under a profiler, one pseudolidar.frame (its unit the frame index),
    # copy_out and compact a process call or rig step; no wait on the CPU;
    # on the graph path one graph.copy_in a call after the first, inside
    # the frame. Off, nothing is recorded and the answers are the same
    from unsupervised_pseuso_lidar_tpu_torch.utils import profiling

    pipeline = DepthToPointCloudPipeline(_RampDepth(),
                                         PseudoLiDAR(_write_calib(tmp_path / "calib"),
                                                     device="cpu"), device="cpu")
    if graphs:
        _static(pipeline)
    frames = _frames(7, 3 * cameras)

    def call(i):
        if cameras == 1:
            return [pipeline.process(frames[i], i)]
        return pipeline.process_batch(frames[2 * i:2 * i + 2], i)

    profiling.clear_spans()
    off = [call(i) for i in range(3)]
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = [call(i) for i in range(3)]
    for got, want in zip(on, off):
        for a, b in zip(got, want):
            _assert_same(a, b)
    assert sum(len(r.points) for results in on for r in results) > 0
    records = profiling.spans()
    frames_spans = [s for s in records if s.name == "pseudolidar.frame"]
    assert [s.unit for s in frames_spans] == [0, 1, 2]
    assert all(s.parent is None for s in frames_spans)
    roots = {s.id for s in frames_spans}
    for name in ("pseudolidar.copy_out", "pseudolidar.compact"):
        mine = [s for s in records if s.name == name]
        assert len(mine) == 3 and all(s.parent in roots for s in mine), name
        assert [s.unit for s in mine] == [0, 1, 2]
    assert profiling.span_totals("pseudolidar.wait") == (0, 0)
    copies = [s for s in records if s.name == "graph.copy_in"]
    # the graph path's first call here is its third: it replays
    assert len(copies) == (3 if graphs else 0)
    assert all(s.unit in (0, 1, 2) for s in copies)


def _ramp_pipeline(tmp_path, sparsity=0, max_high=1.0):
    """A _RampDepth pipeline on the graph path's CPU protocol."""
    projector = PseudoLiDAR(_write_calib(tmp_path / "calib"), sparsity=sparsity,
                            max_high=max_high, device="cpu")
    return _static(DepthToPointCloudPipeline(_RampDepth(), projector, device="cpu"))


@pytest.mark.parametrize("sparsity,max_high,cameras,scale,offset", [
    (0, 1.0, 1, 1.0, 0.0),
    (3, 1.0, 1, 1.0, 0.0),
    (0, 1.0, 1, 0.0, -1e3),  # every depth negative: no pixel kept
    (0, 1e9, 1, 0.0, 0.0),  # no crop on a scene ahead: every pixel kept
    (0, 1.0, 2, 40.0, 0.0),  # a rig of two, each camera its own count
], ids=["sparsity0", "sparsity3", "none_kept", "all_kept", "rig2"])
def test_the_device_compaction_is_numpy_s_bit_for_bit(tmp_path, sparsity, max_high, cameras,
                                                      scale, offset):
    # process / process_batch, 3 calls (eager, "capture", "replay"): each
    # camera's cloud equals numpy's points[valid] of the uncompacted
    # program (infer) bit for bit, in pixel order, and its depth infer's;
    # the counters advance once a camera frame, by its kept count
    pipeline = _ramp_pipeline(tmp_path, sparsity, max_high)
    frames = (_frames(8, 3 * cameras) * scale + offset).reshape(3, cameras, HEIGHT, WIDTH, 3)
    kept = []
    for i, rig in enumerate(frames):
        before = pipeline.card_compactions, pipeline.kept_points
        got = ([pipeline.process(rig[0], i)] if cameras == 1
               else pipeline.process_batch(rig, i))
        depth, points, valid = pipeline.infer(rig)
        assert len(got) == cameras
        for s, result in enumerate(got):
            want = points[s][valid[s]]
            assert result.points.dtype == np.float32 and result.points.shape == want.shape
            assert np.array_equal(result.points, want) and np.array_equal(result.depth, depth[s])
        counts = [len(r.points) for r in got]
        assert (pipeline.card_compactions, pipeline.kept_points) == (
            before[0] + cameras, before[1] + sum(counts))
        kept += counts
    if offset < 0:
        assert kept == [0] * 3
    elif max_high > 1e6:
        assert kept == [HEIGHT * WIDTH] * 3
    else:
        assert 0 < min(kept) and max(kept) < HEIGHT * WIDTH
    if cameras == 2:
        assert all(a != b for a, b in zip(kept[::2], kept[1::2]))
    assert len(pipeline.graphs.graphs) == 2  # process's body and infer's


@pytest.mark.parametrize("cameras", [1, 2], ids=["process", "process_batch"])
def test_a_held_result_is_not_written_by_later_frames(tmp_path, cameras):
    # a result's depth and cloud, held while the next two frames of its
    # batch shape are served (the last a replay), keep their values
    pipeline = _ramp_pipeline(tmp_path)
    frames = (_frames(9, 4 * cameras) * 40.0).reshape(4, cameras, HEIGHT, WIDTH, 3)

    def serve(i):
        if cameras == 1:
            return [pipeline.process(frames[i, 0], i)]
        return pipeline.process_batch(frames[i], i)

    serve(0)
    held = serve(1)
    copies = [(r.depth.copy(), r.points.copy()) for r in held]
    later = [serve(i) for i in (2, 3)]
    for result, (depth, points) in zip(held, copies):
        assert np.array_equal(result.depth, depth) and np.array_equal(result.points, points)
    assert not np.array_equal(later[-1][0].depth, held[0].depth)
