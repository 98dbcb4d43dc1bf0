"""Port parity for the examples (unsupervised_pseuso_lidar_tpu_torch/examples/),
the counterparts of the JAX scripts examples/toy_problem.py and
examples/dino_turntable.py at the repo root, loaded here from their files.

The toy problem: from JAX's PRNGKey(0) initialization carried across
(weights.state_dict_from_jax), the port's toy step against JAX's step
built with the script's settings, for 3 steps: each step's loss, and the
depth error after the third. JAX's side takes warp_impl="gather", the
exact warp that kernel A computes (the script's default 'mxu' is the
TPU's banded approximation, which the port does not carry).

The turntable: load_dino on a tiny tree written here (5 frames of 660
columns, cameras 10° apart; tests/torch_turntable_fixture.py)
against JAX's load_dino on the same root; warp_err at initialization
against the JAX script's expression; the skip without the data.

The card's chip_smoke phase `examples` runs both at their scripts' sizes.
A port step takes ~0.5 s on one CPU thread.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_turntable_fixture import write_synthetic_turntable
from unsupervised_pseuso_lidar_tpu.geometry.se3 import pose_matrix as jax_pose_matrix
from unsupervised_pseuso_lidar_tpu.geometry.warp import disp_to_depth as jax_disp_to_depth
from unsupervised_pseuso_lidar_tpu.geometry.warp import (
    inverse_warp_from_matrix as jax_inverse_warp_from_matrix,
)
from unsupervised_pseuso_lidar_tpu.losses.total import normalize_depth as jax_normalize_depth
from unsupervised_pseuso_lidar_tpu.train.config import Config as JaxConfig
from unsupervised_pseuso_lidar_tpu.train.trainer import create_train_state as jax_create_state
from unsupervised_pseuso_lidar_tpu.train.trainer import make_train_step as jax_make_train_step
from unsupervised_pseuso_lidar_tpu.train.trainer import (
    normalize_uint8_batch as jax_normalize_uint8_batch,
)
from unsupervised_pseuso_lidar_tpu_torch.examples import dino_turntable, toy_problem
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import create_train_state
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the toy script's sizes; each step's loss (relative), the depth error
# after step 3 (relative)
TOY = dict(batch=4, height=64, width=96, scene_depth=10.0, cam_tx=0.01)
TOY_STEPS, TOY_LONG_STEPS, LOSS_RTOL, ERROR_RTOL = 3, 150, 1e-5, 1e-4
# the tiny turntable tree and load_dino's output size
DINO_FRAMES, DINO_SRC, DINO_HW = 5, (660, 120), (48, 64)
WARP_ERR_RTOL = 1e-5


def _jax_script(name):
    """The JAX package's examples/<name>.py at the repo root, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _carry(config, jax_state, steps_per_epoch):
    """The port's TrainState of `config` with the JAX state's depth weights
    and BatchNorm statistics (the pose net is not trained: semi_sup_pose)."""
    state = create_train_state(config, torch.Generator().manual_seed(0), steps_per_epoch,
                               "cpu")
    params = jax.tree.map(np.asarray, jax_state.params["depth"])
    stats = jax.tree.map(np.asarray, jax_state.batch_stats["depth"])
    state.depth_model.load_state_dict(state_dict_from_jax(params, stats, "DispResNet"),
                                      strict=True)
    return state


def _toy_raw(batch, height, width):
    """The toy script's config dict (its :42-66)."""
    return {
        "model": {"name": "toy", "depth": {"name": "DispResNet"},
                  "pose": {"name": "PoseNet"}},
        "datasets": {"augmentation": {"image_width": width, "image_height": height},
                     "sequence_length": 3},
        "action": {"batch_size": batch, "semi_sup_pose": True, "smooth_on": "disp",
                   "smooth_weight": 1e-3,
                   "optimizer": {"depth": {"lr": 1e-4}, "pose": {"lr": 1e-4}}},
    }


def _dino_raw(batch, height, width):
    """The turntable script's config dict (its :175-188)."""
    return {
        "model": {"name": "dino", "depth": {"name": "DispResNet"},
                  "pose": {"name": "PoseNet"}},
        "datasets": {"augmentation": {"image_width": width, "image_height": height}},
        "action": {"batch_size": batch, "learning_rate": 1e-4},
    }


@pytest.mark.parametrize("example", ["toy", "dino"])
def test_configs_are_the_scripts(example):
    # each script's config dict through JAX's Config, field for field
    if example == "toy":
        ours, raw = toy_problem.toy_config(4, 64, 96), _toy_raw(4, 64, 96)
    else:
        ours, raw = dino_turntable.dino_config(8, 192, 256), _dino_raw(8, 192, 256)
    assert ours.to_dict() == JaxConfig.from_dict(raw).to_dict()


def _toy_pair():
    """(JAX's state, its depth model, its step; the port's state, its step)
    of the toy script's settings, the port's depth net carrying JAX's
    PRNGKey(0) initialization; JAX's step with the exact gather warp."""
    b, h, w = TOY["batch"], TOY["height"], TOY["width"]
    jax_state, jax_depth, jax_pose, tx = jax_create_state(
        JaxConfig.from_dict(_toy_raw(b, h, w)), jax.random.PRNGKey(0), steps_per_epoch=200)
    jax_step = jax_make_train_step(jax_depth, jax_pose, tx, semi_sup_pose=True,
                                   smooth_on="disp", smooth_weight=1e-3, warp_impl="gather")
    state = _carry(toy_problem.toy_config(b, h, w), jax_state, 200)
    return jax_state, jax_depth, jax_step, state, toy_problem.make_toy_step(state, "cpu")


def _jax_depth_error(jax_depth, jax_state, data):
    """The toy script's depth_error."""
    disps = jax_depth.apply({"params": jax_state.params["depth"],
                             "batch_stats": jax_state.batch_stats["depth"]},
                            jnp.asarray(data["tgt"]), train=False)
    return float(jnp.abs(jax_disp_to_depth(disps[0][..., 0]) - TOY["scene_depth"]).mean())


def test_toy_steps_match_jax():
    # 3 steps from JAX's PRNGKey(0) init: each step's loss, then the
    # eval-mode depth error, against the JAX step with the script's
    # settings on the same batches
    jax_state, jax_depth, jax_step, state, step = _toy_pair()
    for i in range(TOY_STEPS):
        data = toy_problem.toy_batch(TOY["batch"], TOY["height"], TOY["width"], i,
                                     TOY["scene_depth"], TOY["cam_tx"])
        assert "groundtruth" not in data
        jax_state, ref = jax_step(jax_state, {k: jnp.asarray(v) for k, v in data.items()})
        got = step(data)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=LOSS_RTOL,
                                   err_msg=f"step {i + 1}")
    want = _jax_depth_error(jax_depth, jax_state, data)
    got = toy_problem.depth_error(state.depth_model, data, TOY["scene_depth"], "cpu")
    np.testing.assert_allclose(got, want, rtol=ERROR_RTOL)


@pytest.mark.slow
def test_toy_problem_over_150_steps_ends_where_jax_s_does():
    # JAX's TestToyProblem (150 steps, the error list at step 1 and every
    # 15th) in both packages from JAX's init. It does not converge in
    # either: the disparity collapses to 0 (depth 100 m, error 90 m) after
    # the first fall, with JAX's mxu and gather warps alike, so JAX's own
    # test fails on the CPU. Held: the same first error, the same verdict
    # and the same last error
    jax_state, jax_depth, jax_step, state, step = _toy_pair()
    ours, theirs = [], []
    for i in range(TOY_LONG_STEPS):
        data = toy_problem.toy_batch(TOY["batch"], TOY["height"], TOY["width"], i,
                                     TOY["scene_depth"], TOY["cam_tx"])
        jax_state, _ = jax_step(jax_state, {k: jnp.asarray(v) for k, v in data.items()})
        step(data)
        if i == 0 or (i + 1) % (TOY_LONG_STEPS // 10) == 0:
            theirs.append(_jax_depth_error(jax_depth, jax_state, data))
            ours.append(toy_problem.depth_error(state.depth_model, data,
                                                TOY["scene_depth"], "cpu"))
    print("port", ours, "jax", theirs)
    np.testing.assert_allclose(ours[0], theirs[0], rtol=ERROR_RTOL)
    assert (ours[-1] < ours[0]) == (theirs[-1] < theirs[0]), (ours, theirs)
    np.testing.assert_allclose(ours[-1], theirs[-1], rtol=ERROR_RTOL)


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dino"))
    width, height = DINO_SRC
    return write_synthetic_turntable(root, num=DINO_FRAMES, width=width, height=height,
                                     seed=3)


def test_load_dino_equals_jax(tiny_tree):
    # images bit for bit, intrinsics and ground-truth poses at 1e-6; the
    # JAX loader test's own checks: 10° a step, equal translation norms
    ours = dino_turntable.load_dino(*DINO_HW, root=tiny_tree)
    ref = _jax_script("dino_turntable").load_dino(*DINO_HW, root=tiny_tree)
    assert sorted(ours) == sorted(ref) == ["intrinsics", "oxts", "ref_imgs", "tgt"]
    num = DINO_FRAMES - 2
    assert ours["ref_imgs"].shape == (num, 2, *DINO_HW, 3) and ours["tgt"].dtype == np.uint8
    np.testing.assert_array_equal(ours["tgt"], ref["tgt"])
    np.testing.assert_array_equal(ours["ref_imgs"], ref["ref_imgs"])
    for key in ("intrinsics", "oxts"):
        assert ours[key].dtype == ref[key].dtype == np.float32
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6, atol=1e-6, err_msg=key)
    angles = np.linalg.norm(ours["oxts"][:, :, :3], axis=-1)
    np.testing.assert_allclose(angles, 2 * np.pi / 36, rtol=2e-2)
    trans = np.linalg.norm(ours["oxts"][:, :, 3:], axis=-1)
    np.testing.assert_allclose(trans, trans.mean(), rtol=5e-2)


def _jax_warp_err(depth_model, state, b):
    """The JAX script's warp_err (its :206-232) on a numpy batch."""
    b = {k: jnp.asarray(v) for k, v in b.items()}
    img = b["tgt"].astype(jnp.float32) / 255.0
    ref = b["ref_imgs"][:, 0].astype(jnp.float32) / 255.0
    disps = depth_model.apply({"params": state.params["depth"],
                               "batch_stats": state.batch_stats["depth"]},
                              jax_normalize_uint8_batch(b)["tgt"], train=False)
    depth = jax_normalize_depth(jax_disp_to_depth(disps[0][..., 0]))
    warped = jax_inverse_warp_from_matrix(ref, depth, jax_pose_matrix(b["oxts"][:, 0]),
                                          b["intrinsics"], impl="gather")
    valid = (jnp.abs(warped).sum(-1, keepdims=True) > 0).astype(jnp.float32)
    abs_err = jnp.sum(jnp.abs(warped - img) * valid) / (jnp.sum(valid) * 3.0)
    return float(abs_err), float(jnp.mean(img - warped))


def test_warp_err_at_initialization_matches_jax(tiny_tree):
    # JAX's PRNGKey(0) init carried across, every triplet of the tree
    height, width = DINO_HW
    data = dino_turntable.load_dino(height, width, tiny_tree)
    config = dino_turntable.dino_config(len(data["tgt"]), height, width)
    jax_state, jax_depth, _, _ = jax_create_state(
        JaxConfig.from_dict(_dino_raw(len(data["tgt"]), height, width)),
        jax.random.PRNGKey(0), 1000)
    state = _carry(config, jax_state, 1000)
    got = [float(e) for e in dino_turntable.warp_err(state.depth_model, data, "cpu")]
    want = _jax_warp_err(jax_depth, jax_state, data)
    np.testing.assert_allclose(got, want, rtol=WARP_ERR_RTOL)
    # the ground-truth pose's warp beats the identity
    identity = np.abs(data["tgt"] / 255.0 - data["ref_imgs"][:, 0] / 255.0).mean()
    assert got[0] < identity, (got, identity)


def test_missing_data_skips_as_jax_does(monkeypatch, capsys, tmp_path):
    # both scripts without the dataset: JAX's message, None
    missing = str(tmp_path / "missing")
    jax_dino = _jax_script("dino_turntable")
    monkeypatch.setattr(jax_dino, "load_dino",
                        functools.partial(jax_dino.load_dino, root=missing))
    assert jax_dino.run(steps=1) is None
    want = capsys.readouterr().out
    assert want.startswith("dino dataset unavailable")
    monkeypatch.setattr(dino_turntable, "DINO_ROOT", missing)
    assert dino_turntable.run(steps=1, device="cpu") is None
    assert capsys.readouterr().out == want
