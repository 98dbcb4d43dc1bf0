"""The port's training entry point (cli/train.py), its host-async prefetch
(data/pipeline.py) and its metric logger (utils/logging.py), on the CPU.

Each shipped config's model pair and objective runs at a small size (the
config's YAML with the image cut to 32x64, batch 2, two synthetic batches
an epoch): configs/basic_config.yaml is DispResNet-18 + PoseFc with
loss_mode 'min', configs/synthetic.yaml and configs/test_config.yaml are
DispResNet-18 + PoseNet with the default 'mean'.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from unsupervised_pseuso_lidar_tpu_torch.cli import train as train_cli
from unsupervised_pseuso_lidar_tpu_torch.data.pipeline import prefetch_to_device
from unsupervised_pseuso_lidar_tpu_torch.utils.logging import MetricLogger

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
    (["--synthetic", "--profile", "trace_dir"], NotImplementedError),
    (["--synthetic", "--op-breakdown"], NotImplementedError),
    ([], NotImplementedError),  # KITTI: the host-data modules are not ported
])
def test_cli_refuses_what_is_not_ported(argv, error):
    with pytest.raises(error):
        train_cli.main(["--config", "configs/basic_config.yaml", "--device", "cpu", *argv])


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
