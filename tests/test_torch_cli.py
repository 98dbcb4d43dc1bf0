"""The port's entry points on the CPU: cli/train.py (synthetic and
KITTI), cli/evaluate.py, cli/odometry.py and cli/splits.py, the host-async
prefetch (data/pipeline.py) and the metric logger (utils/logging.py).

Each shipped config's model pair and objective runs at a small size (the
config's YAML with the image cut to 32x64, batch 2, two synthetic batches
an epoch): configs/basic_config.yaml is DispResNet-18 + PoseFc with
loss_mode 'min', configs/synthetic.yaml and configs/test_config.yaml are
DispResNet-18 + PoseNet with the default 'mean'. The KITTI entry points run
over the synthesized mini-KITTI tree of tests/test_data.py and are held to
the JAX package's on the same weights (bridged with
weights.state_dict_from_jax into a port checkpoint).
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_data import DATE, DRIVE, NUM_FRAMES, mini_kitti  # noqa: F401
from tests.test_torch_eval import rot_err_oracle
from unsupervised_pseuso_lidar_tpu.cli import odometry as jax_odometry_cli
from unsupervised_pseuso_lidar_tpu.cli import splits as jax_splits_cli
from unsupervised_pseuso_lidar_tpu.cli import train as jax_train_cli
from unsupervised_pseuso_lidar_tpu.data import kitti as jax_kitti
from unsupervised_pseuso_lidar_tpu.eval import pose as jax_pose_eval
from unsupervised_pseuso_lidar_tpu.eval import trajectory as jax_trajectory
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train import config as jax_config
from unsupervised_pseuso_lidar_tpu.train import trainer as jax_trainer
from unsupervised_pseuso_lidar_tpu_torch.cli import evaluate as eval_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import odometry as odometry_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import splits as splits_cli
from unsupervised_pseuso_lidar_tpu_torch.cli import train as train_cli
from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import CheckpointManager
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
HEIGHT, WIDTH, BATCH = 32, 64, 2


def _write_config(tmp_path, name, **action):
    with open(os.path.join("configs", name)) as f:
        raw = yaml.safe_load(f)
    raw["datasets"]["augmentation"].update(image_height=HEIGHT, image_width=WIDTH)
    raw["action"].update(batch_size=BATCH, log_freq=1,
                         checkpoint_dir=str(tmp_path / "checkpoints"), **action)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _main(config, epochs):
    return train_cli.main(["--config", config, "--synthetic", "--epochs", str(epochs),
                           "--synthetic-batches", "2", "--device", "cpu"])


@pytest.mark.parametrize("name,pose_net,loss_mode", [
    ("basic_config.yaml", "PoseFc", "min"),
    ("synthetic.yaml", "PoseNet", "mean"),
    ("test_config.yaml", "PoseNet", "mean"),
])
def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys, name, pose_net, loss_mode):
    # epoch 0 writes epoch_00000.pth and logs a JSON line a step; a second
    # run of the same config with from_scratch: False restores it and
    # trains epoch 1 only (step 2 -> 4), writing epoch_00001.pth
    trainer = _main(_write_config(tmp_path, name), epochs=1)
    assert type(trainer.state.pose_model).__name__ == pose_net
    assert trainer.config.action.loss_mode == loss_mode
    directory = trainer.checkpoints.directory
    assert directory == os.path.join(str(tmp_path / "checkpoints"),
                                     trainer.config.model.name)
    assert os.listdir(directory) == ["epoch_00000.pth"]
    assert trainer.epoch == 0 and trainer.state.step == 2
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)

    resumed = _main(_write_config(tmp_path, name, from_scratch=False), epochs=2)
    assert resumed.epoch == 1 and resumed.state.step == 4
    assert sorted(os.listdir(directory)) == ["epoch_00000.pth", "epoch_00001.pth"]
    assert [json.loads(line)["step"] for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")] == [3, 4]


@pytest.mark.parametrize("argv,error", [
    (["--synthetic", "--mesh", "2"], ValueError),
    # a config naming a model of a later slice (ROADMAP.md slices 9, 10)
    (["--synthetic", "--config", "BtsModel.yaml"], NotImplementedError),
    (["--synthetic", "--config", "PoseDecoder.yaml"], NotImplementedError),
])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, error):
    for name, head in (("BtsModel", "depth"), ("PoseDecoder", "pose")):
        raw = yaml.safe_load(open(os.path.join("configs", "test_config.yaml")))
        raw["model"][head]["name"] = name
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(raw))
    argv = [str(tmp_path / a) if a.endswith(".yaml") else a for a in argv]
    with pytest.raises(error):
        train_cli.main(["--config", "configs/basic_config.yaml", "--device", "cpu", *argv])


def test_cli_profiles_the_fit_and_breaks_down_a_step(tmp_path, capsys):
    # --profile traces the whole fit into a *.pt.trace.json; --op-breakdown
    # then prints the per-family time of 3 train steps (CPU self time here:
    # no card) and keeps it on the trainer
    from unsupervised_pseuso_lidar_tpu_torch.utils.trace import newest_trace, summarize_trace

    config = _write_config(tmp_path, "test_config.yaml")
    trace_dir = tmp_path / "trace"
    trainer = train_cli.main(["--config", config, "--synthetic", "--epochs", "1",
                              "--synthetic-batches", "2", "--device", "cpu",
                              "--op-breakdown", "--profile", str(trace_dir)])
    out = capsys.readouterr().out
    assert "[trace] CPU self time by op family" in out and "host window" in out
    breakdown = trainer.op_breakdown
    assert breakdown.steps == 3 and not breakdown.on_device and breakdown.total_ms > 0
    assert breakdown["aten::convolution_backward"] > 0
    # 2 steps of the fit, 2 warm-up and 3 profiled ones
    assert trainer.state.step == 7
    path = newest_trace(str(trace_dir))
    assert path is not None and path.endswith(".pt.trace.json")
    families = {fam for fam, _, _ in summarize_trace(path)}
    assert "aten::convolution_backward" in families and "aten::mkldnn_convolution" in families


def test_prefetch_yields_every_batch_in_order():
    batches = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(i + 1)}
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert sorted(g) == ["x", "y"]
        for key in b:
            assert torch.is_tensor(g[key]) and g[key].device.type == "cpu"
            np.testing.assert_array_equal(g[key].numpy(), b[key])


def test_prefetch_raises_the_loader_error_in_the_consumer():
    def loader():
        yield {"x": np.zeros(2)}
        raise OSError("disk gone")

    it = prefetch_to_device(loader(), device="cpu")
    assert float(next(it)["x"].sum()) == 0.0
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_metric_logger_prints_one_json_line_a_call(capsys):
    log = MetricLogger()
    log({"loss": torch.tensor(0.25), "d1": 0.5}, 7)
    (line,) = capsys.readouterr().out.splitlines()
    record = json.loads(line)
    assert record["step"] == 7 and record["loss"] == 0.25 and record["d1"] == 0.5


# --------------------------------------------------------------------------
# the KITTI entry points over the mini-KITTI tree
# --------------------------------------------------------------------------

KITTI_HW = (64, 96)


def _kitti_config(tmp_path, mini_kitti, split=None, name="kitti_cli", **action):  # noqa: F811
    raw = {
        "model": {"name": name, "depth": {"name": "DispResNet"}, "pose": {"name": "PoseNet"}},
        "datasets": {"path": mini_kitti["kitti"], "split": split or "",
                     "augmentation": {"image_height": KITTI_HW[0], "image_width": KITTI_HW[1]}},
        "action": {"batch_size": 2, "num_workers": 2, "log_freq": 1, "split": [0.6, 0.4],
                   "loss_mode": "min", "checkpoint_dir": str(tmp_path / "ckpt"), **action},
    }
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path), raw


@pytest.fixture(scope="module")
def jax_weights():
    """Flax DispResNet-18 + PoseNet (plain convs) variables at KITTI_HW with
    random BatchNorm statistics and a pose head bias that moves the warp
    by a few pixels."""
    depth = jax_build_model("DispResNet")
    pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, *KITTI_HW, 3), jnp.float32)
    dv = jax.jit(partial(depth.init, train=False))(jax.random.PRNGKey(0), img)
    pv = jax.jit(pose.init)(jax.random.PRNGKey(1), img, [img, img])
    params = {"depth": jax.tree.map(np.asarray, dv["params"]),
              "pose": jax.tree.map(np.asarray, pv["params"])}
    rng = np.random.default_rng(9)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, dv["batch_stats"]))
    head = params["pose"]["TorchConv_7"]["Conv_0"]
    head["bias"] = (rng.normal(size=(2, 6)) * np.array([0.005] * 3 + [0.03] * 3)
                    / 0.06).reshape(-1).astype(np.float32)
    state = jax_trainer.TrainState(step=0, params=params,
                                   batch_stats={"depth": stats, "pose": {}}, opt_state=None)
    return depth, pose, state


def _save_port_checkpoint(raw, jax_weights):
    """The JAX weights as the port's epoch-0 checkpoint of raw's model."""
    _, _, state = jax_weights
    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(state_dict_from_jax(state.params["depth"],
                                              state.batch_stats["depth"], "DispResNet"))
    pose_net = build_model("PoseNet", device="cpu")
    pose_net.load_state_dict(state_dict_from_jax(state.params["pose"], {}, "PoseNet"))
    cfg = config_module.Config.from_dict(raw)
    optimizer = make_optimizer(cfg, depth, pose_net)
    CheckpointManager(os.path.join(raw["action"]["checkpoint_dir"], raw["model"]["name"])).save(
        TrainState(depth, pose_net, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1)), 0)


def test_splits_cli_matches_jax(mini_kitti, tmp_path, capsys):  # noqa: F811
    drive = os.path.join(mini_kitti["kitti"], DATE, DRIVE)
    for argv in (["annotated", "--kitti", mini_kitti["kitti"], "--depth", mini_kitti["depth"]],
                 ["drive", "--drive", drive, "--ref-offset", "2"]):
        ours, theirs = tmp_path / f"{argv[0]}_port.txt", tmp_path / f"{argv[0]}_jax.txt"
        lines = splits_cli.main([*argv, "--out", str(ours)])
        printed = capsys.readouterr().out
        assert lines == jax_splits_cli.main([*argv, "--out", str(theirs)])
        assert printed.replace(str(ours), "X") == capsys.readouterr().out.replace(str(theirs), "X")
        assert ours.read_bytes() == theirs.read_bytes() and lines


def test_kitti_cli_exits_on_a_missing_split_as_jax_does(mini_kitti, tmp_path):  # noqa: F811
    path, _ = _kitti_config(tmp_path, mini_kitti, split=str(tmp_path / "missing.txt"))
    for main in (train_cli.main, jax_train_cli.main):
        with pytest.raises(SystemExit, match="error: Split file not found"):
            main(["--config", path, *(["--device", "cpu"] if main is train_cli.main else [])])


def test_cli_trains_on_kitti_and_resumes(mini_kitti, tmp_path, capsys):  # noqa: F811
    # 5 samples, 2 validate: one training step an epoch (batch 2,
    # drop_last) with color jitter and flips, thread workers; the resume
    # trains epoch 1 in spawned process workers and validates both epochs
    split = str(tmp_path / "split.txt")
    splits_cli.main(["annotated", "--kitti", mini_kitti["kitti"], "--depth",
                     mini_kitti["depth"], "--out", split])
    aug = {"color_jitter": True, "hflip": True}
    path, raw = _kitti_config(tmp_path, mini_kitti, split)
    raw["datasets"]["augmentation"].update(aug)
    (tmp_path / "kitti_cli.yaml").write_text(yaml.safe_dump(raw))
    trainer = train_cli.main(["--config", path, "--epochs", "1", "--device", "cpu"])
    directory = trainer.checkpoints.directory
    assert os.listdir(directory) == ["epoch_00000.pth"]
    assert trainer.state.step == 1 and len(trainer.batch_waits) == 1
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert records[0]["step"] == 1 and "automask_keep" in records[0]
    val = records[-1]
    assert {"val_loss", "val_abs_rel", "val_d1"} <= set(val)
    assert all(np.isfinite(v) for v in val.values())

    raw["action"].update(from_scratch=False, worker_type="process")
    (tmp_path / "kitti_cli.yaml").write_text(yaml.safe_dump(raw))
    resumed = train_cli.main(["--config", path, "--epochs", "2", "--device", "cpu"])
    assert resumed.epoch == 1 and resumed.state.step == 2
    assert sorted(os.listdir(directory)) == ["epoch_00000.pth", "epoch_00001.pth"]
    assert all(np.isfinite(json.loads(line)["loss"])
               for line in capsys.readouterr().out.splitlines() if line.startswith("{"))


def _jax_validate(jax_weights, raw, **step_kwargs):
    """JAX's eval step over JAX's batches of raw's split (drop_last off),
    averaged as JAX's Trainer.validate averages; and the float64 oracle of
    the rotation error on JAX's poses (tests/test_torch_eval.py), its value
    and JAX's fp32 rounding bound averaged the same way."""
    depth, pose, state = jax_weights
    cfg = jax_config.Config.from_dict(raw)
    dataset = jax_kitti.UnSupKittiDataset(cfg)
    step = jax_trainer.make_eval_step(depth, pose, loss_mode=cfg.action.loss_mode,
                                      warp_impl="gather", **step_kwargs)
    sums, oracle, count = {}, np.zeros(2), 0
    for batch in dataset.batches(list(range(len(dataset))), 2, 1, drop_last=False):
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        metrics, _ = step(state, batch)
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        poses = jax_pose_eval.pose_forward(pose, state.params, state.batch_stats,
                                           jax_trainer.normalize_uint8_batch(batch))
        oracle += rot_err_oracle(poses, batch["oxts"])
        count += 1
    return {k: v / count for k, v in sums.items()}, *(oracle / count)


@pytest.mark.parametrize("split_kind", ["annotated", "drive"])
def test_evaluate_cli_matches_the_jax_eval_step(mini_kitti, tmp_path, jax_weights,  # noqa: F811
                                                split_kind, capsys):
    # the Eigen protocol and pose metrics over the whole split (5 samples
    # in batches of 2, the last of 1), ground truth from the annotated
    # PNGs or rasterized from the velodyne scans, the JAX weights restored
    # from a port checkpoint: every metric at rel 1e-5 (the worst measured
    # on the CPU is 1.1e-7, sq_rel); the rotation error
    # (float64 in the port, fp32 in JAX) against the float64 oracle on
    # JAX's poses at rel 1e-5, and JAX's within its fp32 rounding of it
    split = str(tmp_path / f"{split_kind}.txt")
    drive = os.path.join(mini_kitti["kitti"], DATE, DRIVE)
    splits_cli.main(["drive", "--drive", drive, "--out", split] if split_kind == "drive" else
                    ["annotated", "--kitti", mini_kitti["kitti"], "--depth",
                     mini_kitti["depth"], "--out", split])
    capsys.readouterr()
    path, raw = _kitti_config(tmp_path, mini_kitti, split)
    _save_port_checkpoint(raw, jax_weights)
    argv = ["--config", path, "--protocol", "eigen", "--pose-metrics", "--device", "cpu"]
    if split_kind == "drive":
        argv.append("--velo-gt")
        raw["datasets"]["velo_gt"] = True
    got = eval_cli.main(argv)
    printed = json.loads(capsys.readouterr().out)
    ref, exact, bound = _jax_validate(jax_weights, raw, eval_protocol="eigen",
                                      pose_metrics=True)
    assert sorted(got) == sorted(ref) == sorted(printed)
    assert all(np.isfinite(v) for v in got.values())
    assert got["pose_ate"] > 0 and got["abs_rel"] > 0
    np.testing.assert_allclose(got.pop("pose_rot_err_deg"), exact, rtol=1e-5)
    assert abs(ref.pop("pose_rot_err_deg") - exact) <= bound
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-7, err_msg=key)


def _jax_trajectory_lines(jax_weights, raw):
    """The pose net's trajectory over the drive as JAX's cli.odometry
    computes it, with the JAX weights (its windows, batches of 2)."""
    _, pose, state = jax_weights
    dataset = jax_kitti.UnSupStackedDataset(jax_config.Config.from_dict(raw))
    rel = []
    for start in range(0, len(dataset), 2):
        batch = jax_kitti.collate([dataset.load_sample(i, with_groundtruth=False)
                                   for i in range(start, min(start + 2, len(dataset)))])
        batch = jax_trainer.normalize_uint8_batch({k: jnp.asarray(v) for k, v in batch.items()})
        rel.append(np.asarray(jax_pose_eval.pose_forward(pose, state.params, state.batch_stats,
                                                         batch)))
    rel = np.concatenate(rel)
    chain = jax_trajectory.integrate_relative_poses(rel[:, 1])
    t10 = jax_trajectory.relative_matrices(rel[:1, 0], mode="axis_angle")[0]
    world = np.concatenate([np.eye(4)[None], np.einsum("ij,njk->nik", t10, chain)])
    return jax_trajectory.kitti_odometry_lines(world)


def test_odometry_cli_matches_jax(mini_kitti, tmp_path, jax_weights):  # noqa: F811
    # the ground-truth file is JAX cli.odometry's to atol 1e-9 (float64
    # on both sides); the predicted trajectory equals JAX's with the same
    # weights to atol 1e-5
    path, raw = _kitti_config(tmp_path, mini_kitti)
    _save_port_checkpoint(raw, jax_weights)
    out, gt_out = tmp_path / "poses.txt", tmp_path / "gt.txt"
    metrics = odometry_cli.main(["--config", path, "--out", str(out), "--gt-out", str(gt_out),
                                 "--device", "cpu"])
    jax_gt = tmp_path / "jax_gt.txt"
    jax_odometry_cli.main(["--config", path, "--out", str(tmp_path / "jax_poses.txt"),
                           "--gt-out", str(jax_gt)])

    def rows(lines):
        return np.array([[float(x) for x in line.split()] for line in lines])

    got_gt = rows(gt_out.read_text().splitlines())
    assert got_gt.shape == (NUM_FRAMES, 12)
    np.testing.assert_allclose(got_gt, rows(jax_gt.read_text().splitlines()), rtol=0, atol=1e-9)
    assert len({tuple(r) for r in got_gt}) == NUM_FRAMES
    got = rows(out.read_text().splitlines())
    ref = rows(_jax_trajectory_lines(jax_weights, raw))
    assert got.shape == ref.shape == (NUM_FRAMES, 12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(got[-1] - got[0]).max() > 1e-3
    assert metrics["frames"] == NUM_FRAMES and metrics["drives"] == 1
    assert all(np.isfinite(metrics[k]) for k in ("pose_ate", "pose_rot_err_deg"))
