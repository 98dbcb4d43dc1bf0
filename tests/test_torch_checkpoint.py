"""Checkpoints, resume and pretrained init of the port (train/checkpoint.py,
Trainer), on the CPU at a small size of configs/basic_config.yaml
(DispResNet-18 + PoseFc, loss_mode 'min'), and the reference-schema `.pth`
interop with the JAX package."""

import os
import signal
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.checkpoint import (
    export_reference_checkpoint as jax_export_reference_checkpoint,
)
from unsupervised_pseuso_lidar_tpu.train.checkpoint import import_torch_state
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train import checkpoint
from unsupervised_pseuso_lidar_tpu_torch.train.config import load_config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer, create_train_state

torch.set_num_threads(1)
HEIGHT, WIDTH, BATCH = 32, 64, 2


def _config(tmp_path, **action):
    cfg = load_config("configs/basic_config.yaml")
    aug = cfg.datasets.augmentation
    aug.image_height, aug.image_width = HEIGHT, WIDTH
    cfg.action.batch_size = BATCH
    cfg.action.checkpoint_dir = str(tmp_path / "checkpoints")
    for key, value in action.items():
        setattr(cfg.action, key, value)
    return cfg


def _batches(n, epoch=0):
    return list(SyntheticTripletDataset(n, BATCH, HEIGHT, WIDTH, seed=5,
                                        uint8_images=True).batches(epoch))


def _state_tensors(trainer):
    """Every parameter, buffer and optimizer-state tensor of a Trainer."""
    state = trainer.state
    out = {f"depth.{k}": v for k, v in state.depth_model.state_dict().items()}
    out.update({f"pose.{k}": v for k, v in state.pose_model.state_dict().items()})
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in slots.items()})
    return out


def _assert_bit_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert sorted(ta) == sorted(tb)
    unequal = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not unequal, unequal


def test_resume_continues_bit_for_bit(tmp_path):
    # run A trains epoch 0 (2 steps), checkpoints, then takes step 3; run B
    # restores the checkpoint (from_scratch False) into fresh models and
    # takes the same step 3: every parameter, BatchNorm buffer and Adam
    # moment is bit-equal after the restore and after the step
    cfg = _config(tmp_path, num_epochs=1)
    data = SyntheticTripletDataset(2, BATCH, HEIGHT, WIDTH, seed=5, uint8_images=True)
    a = Trainer(cfg, data, device="cpu")
    a.fit(make_train_iter=lambda epoch: data.batches(epoch))
    path = a.checkpoints.path(0)
    assert os.listdir(os.path.dirname(path)) == ["epoch_00000.pth"]
    saved = checkpoint.load_torch_checkpoint(path)
    assert {"epoch", "dpth_mdl_state_dict", "pose_mdl_state_dict",
            "optimizer_state_dict"} <= set(saved)
    assert saved["epoch"] == 0 and saved["step"] == 2

    b = Trainer(_config(tmp_path, num_epochs=2, from_scratch=False), data, device="cpu")
    assert b.epoch == 1 and b.state.step == 2
    assert b.state.scheduler.last_epoch == a.state.scheduler.last_epoch == 2
    _assert_bit_equal(a, b)
    batch = _batches(1, epoch=1)[0]
    metrics_a, metrics_b = a.train_step(batch), b.train_step(batch)
    assert all(torch.equal(metrics_a[k], metrics_b[k]) for k in metrics_a)
    _assert_bit_equal(a, b)


def test_sigterm_checkpoints_the_epoch_and_stops(tmp_path):
    # a SIGTERM during epoch 0 of 3: the epoch finishes, is checkpointed,
    # and fit stops; the previous handler is back afterwards
    cfg = _config(tmp_path, num_epochs=3)
    trainer = Trainer(cfg, device="cpu")
    batches = _batches(2)

    def train_iter(epoch):
        for i, batch in enumerate(batches):
            if i == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    before = signal.getsignal(signal.SIGTERM)
    trainer.fit(train_iter)
    assert signal.getsignal(signal.SIGTERM) is before
    assert trainer.epoch == 0 and trainer.state.step == 2
    assert os.listdir(trainer.checkpoints.directory) == ["epoch_00000.pth"]


def test_fit_validates_logs_and_checkpoints_every_epoch(tmp_path):
    cfg = _config(tmp_path, num_epochs=2, eval_protocol="eigen", eval_pose=True)
    logged = []
    trainer = Trainer(cfg, log_fn=lambda m, step: logged.append((step, m)), device="cpu")
    metrics = trainer.fit(lambda epoch: _batches(1, epoch), lambda: _batches(1))
    assert sorted(os.listdir(trainer.checkpoints.directory)) == [
        "epoch_00000.pth", "epoch_00001.pth"]
    assert [step for step, _ in logged] == [1, 2]
    for key in ("val_loss", "val_abs_rel", "val_d1", "val_pose_ate", "val_pose_rot_err_deg"):
        assert np.isfinite(metrics[key]), key


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_pretrained_torchvision_resnet_sets_the_encoder_only(tmp_path, suffix):
    # a random torchvision-schema resnet18 state dict (conv1.*, bn1.*,
    # layer1-4.*, fc.*) written by the test: the encoder takes it, fc.* is
    # dropped, the decoder keeps the seeded init
    gen = torch.Generator().manual_seed(11)
    encoder = build_model("DispResNet", device="cpu").encoder.encoder.state_dict()
    state = {k: (torch.randn(v.shape, generator=gen) if v.is_floating_point() else v)
             for k, v in encoder.items()}
    state["fc.weight"] = torch.randn(1000, 512, generator=gen)
    state["fc.bias"] = torch.randn(1000, generator=gen)
    path = str(tmp_path / f"resnet18{suffix}")
    if suffix == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in state.items()})
    else:
        torch.save(state, path)
    cfg = _config(tmp_path)
    plain = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    cfg.model.depth.pretrained_path = path
    loaded = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = loaded.depth_model.state_dict()
    for key, value in state.items():
        if not key.startswith("fc."):
            assert torch.equal(got[f"encoder.encoder.{key}"], value), key
    for key, value in plain.depth_model.state_dict().items():
        if key.startswith("decoder."):
            assert torch.equal(got[key], value), key
    assert not any("fc." in k for k in got)


def test_pretrained_from_a_jax_reference_checkpoint_matches_jax(tmp_path):
    # the JAX package's export_reference_checkpoint (DispResNet-18 +
    # PoseFc) as both heads' pretrained_path: the port's depth (eval) and
    # poses equal the flax outputs (atol 1e-4 / 1e-5, as the model tests)
    rng = np.random.default_rng(7)
    depth, pose = jax_build_model("DispResNet"), jax_build_model("PoseFc")
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    dv = jax.jit(partial(depth.init, train=False))(jax.random.PRNGKey(0), img)
    pv = jax.jit(pose.init)(jax.random.PRNGKey(1), img, [img, img])
    params = {"depth": jax.tree.map(np.asarray, dv["params"]),
              "pose": jax.tree.map(np.asarray, pv["params"])}
    params["pose"]["Dense_2"]["kernel"] = rng.normal(
        0, 0.3, params["pose"]["Dense_2"]["kernel"].shape).astype(np.float32)
    stats = {"depth": jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                                   jax.tree.map(np.asarray, dv["batch_stats"])),
             "pose": {}}
    path = str(tmp_path / "reference.pth")
    jax_export_reference_checkpoint(params, stats, "DispResNet", "PoseFc", path)

    cfg = _config(tmp_path)
    cfg.model.depth.pretrained_path = cfg.model.pose.pretrained_path = path
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    imgs = [rng.normal(size=(2, HEIGHT, WIDTH, 3)).astype(np.float32) for _ in range(3)]
    t = [torch.from_numpy(np.ascontiguousarray(i.transpose(0, 3, 1, 2))) for i in imgs]
    ref_disp = jax.jit(partial(depth.apply, train=False))(
        {"params": params["depth"], "batch_stats": stats["depth"]}, jnp.asarray(imgs[0]))[0]
    ref_pose = jax.jit(pose.apply)({"params": params["pose"]}, jnp.asarray(imgs[0]),
                                   [jnp.asarray(imgs[1]), jnp.asarray(imgs[2])])
    with torch.no_grad():
        disp = state.depth_model.eval()(t[0])[0]
        poses = state.pose_model(t[0], t[1:])
    np.testing.assert_allclose(disp.numpy().transpose(0, 2, 3, 1), np.asarray(ref_disp),
                               atol=1e-4)
    assert float(np.abs(np.asarray(ref_pose)).max()) > 1e-3
    np.testing.assert_allclose(poses.numpy(), np.asarray(ref_pose), atol=1e-5)


def test_export_reference_checkpoint_loads_in_jax(tmp_path):
    # the port's reference-schema export: the reference's keys, a fresh
    # single-group Adam over every parameter, and JAX's importer takes
    # both state dicts back to the exported values
    state = create_train_state(_config(tmp_path), torch.Generator().manual_seed(2),
                               device="cpu")
    path = str(tmp_path / "export.pth")
    checkpoint.export_reference_checkpoint(state.depth_model, state.pose_model, path,
                                           epoch=4)
    blob = checkpoint.load_torch_checkpoint(path)
    assert sorted(blob) == sorted(["epoch", "dpth_mdl_state_dict", "pose_mdl_state_dict",
                                   "optimizer_state_dict", "loss", "valid_acc"])
    n_params = (len(list(state.depth_model.parameters()))
                + len(list(state.pose_model.parameters())))
    assert blob["optimizer_state_dict"]["param_groups"][0]["params"] == list(range(n_params))
    pose = jax_build_model("PoseFc")
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    pv = jax.jit(pose.init)(jax.random.PRNGKey(0), img, [img, img])
    params, _ = import_torch_state(pv["params"], {}, blob["pose_mdl_state_dict"], "PoseFc")
    ref = state.pose_model.fc_loc[0].weight.detach().numpy()
    # back in the JAX layout: rows in the HWC flatten order (1x2 map here)
    from unsupervised_pseuso_lidar_tpu_torch.weights import chw_to_hwc_permutation
    np.testing.assert_array_equal(
        np.asarray(params["Dense_0"]["kernel"]),
        ref.T[chw_to_hwc_permutation(12, 1, ref.shape[1] // 12)])
