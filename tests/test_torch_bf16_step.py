"""The bf16 training step of configs/tpu_v5e.yaml on the CPU: the port's
step (bf16 autocast around the models, fp32 loss) against JAX's (flax
models with dtype bfloat16, fp32 loss), from the same weights, and the
port's step run twice.

Both run DispResNet-18 + PoseNet(s2d_convs=0) at 32x64, batch 2, with the
config's objective ('min', smoothness on the disparity at 0.001,
depth_norm) and the port's seeded weights imported into flax's trees
(jax_models). The two packages round to bf16 at different places (flax
casts each layer's inputs, autocast each conv's), so their steps part by
bf16's rounding: over batch seeds 1-6 the loss by 5.4e-4 - 7.6e-4
relative and the gradient, every leaf concatenated, by 0.0064 - 0.014
rel L2. A single leaf is no measure: with depth_norm the
disparity heads' biases get a near-zero difference of large terms.

At 32x64 PoseNet's last strided conv sees a map one column wide, where
oneDNN's bf16 weight gradient reads memory it never wrote
(models/layers.conv2d pads explicitly there).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import CONFIG, LOSS_SETTINGS, _grads_in_opt_state, _rel_l2
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.checkpoint import import_torch_state
from unsupervised_pseuso_lidar_tpu.train.trainer import TrainState as JaxTrainState
from unsupervised_pseuso_lidar_tpu.train.trainer import make_train_step_body
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
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
HEIGHT, WIDTH = 32, 64
# measured over batch seeds 1-6 (module docstring): loss <= 7.6e-4,
# gradient <= 0.014
LOSS_RTOL = 2e-3
GRAD_REL_L2 = 0.05


@pytest.fixture(scope="module")
def jax_models():
    """(params, batch_stats) of flax DispResNet-18 + PoseNet(s2d_convs=0):
    the port's seeded init (JAX's distributions) imported into the trees
    of flax's shapes (jax.eval_shape, so nothing compiles) by the JAX
    package's import_torch_state, with running statistics U(0.5, 1.5) and
    a pose head bias that moves the warp by a few pixels (as
    test_torch_train's jax_models)."""
    img = jax.ShapeDtypeStruct((1, HEIGHT, WIDTH, 3), jnp.float32)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    shapes = {"depth": jax.eval_shape(partial(jax_build_model("DispResNet").init, train=False),
                                      key, img),
              "pose": jax.eval_shape(jax_build_model("PoseNet", s2d_convs=0).init,
                                     key, img, [img, img])}
    gen = torch.Generator().manual_seed(23)
    rng = np.random.default_rng(23)
    out = {}
    for net, name in (("depth", "DispResNet"), ("pose", "PoseNet")):
        state = build_model(name, generator=gen, device="cpu").state_dict()
        for k, v in state.items():
            if k.endswith(("running_mean", "running_var")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
        zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes[net])
        out[net] = import_torch_state(zeros["params"], zeros.get("batch_stats", {}), state, name)
    params = {net: jax.tree.map(np.asarray, p) for net, (p, _) in out.items()}
    head = params["pose"]["TorchConv_7"]["Conv_0"]
    head["bias"] = (rng.normal(size=(2, 6)) * np.array([0.005] * 3 + [0.03] * 3)
                    / 0.06).reshape(-1).astype(np.float32)
    return params, jax.tree.map(np.asarray, out["depth"][1])


@pytest.fixture(scope="module")
def jax_bf16_body():
    depth = jax_build_model("DispResNet", dtype=jnp.bfloat16)
    pose = jax_build_model("PoseNet", s2d_convs=0, dtype=jnp.bfloat16)
    tx = _grads_in_opt_state()
    body = make_train_step_body(depth, pose, tx, loss_mode="min", warp_impl="gather",
                                **LOSS_SETTINGS)
    return jax.jit(body), tx


def _batch(seed):
    return next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=seed,
                                        uint8_images=True).batches())


def _port_step(jax_models, batch):
    """{name: gradient} and the loss of the port's bf16 step from the
    JAX weights (a parameter without a gradient reads zeros)."""
    params, stats = jax_models
    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(state_dict_from_jax(params["depth"], stats, "DispResNet"))
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(state_dict_from_jax(params["pose"], {}, "PoseNet"))
    optimizer = make_optimizer(config.load_config(CONFIG), depth, pose)
    state = TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))
    step = make_train_step(state, device="cpu", loss_mode="min", precision="bf16",
                           **LOSS_SETTINGS)
    metrics = step(batch)
    grads = {f"{net}.{k}": torch.zeros_like(p) if p.grad is None else p.grad
             for net, model in (("depth", depth), ("pose", pose))
             for k, p in model.named_parameters()}
    return float(metrics["loss"]), grads


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bf16_step_matches_jax_s_bf16_step(jax_models, jax_bf16_body, seed):
    body, tx = jax_bf16_body
    params, stats = jax_models
    batch = _batch(seed)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                          batch_stats={"depth": stats, "pose": {}},
                          opt_state=tx.init(params))
    new_state, ref = body(state, {k: jnp.asarray(batch[k]) for k in
                                  ("tgt", "ref_imgs", "intrinsics", "oxts", "groundtruth")})
    grads = jax.tree.map(np.asarray, new_state.opt_state)
    want = {**{f"depth.{k}": v for k, v in
               state_dict_from_jax(grads["depth"], None, "DispResNet").items()},
            **{f"pose.{k}": v for k, v in
               state_dict_from_jax(grads["pose"], None, "PoseNet").items()}}
    loss, got = _port_step(jax_models, batch)
    assert sorted(got) == sorted(want)
    assert all(torch.isfinite(g).all() for g in got.values())
    np.testing.assert_allclose(loss, float(ref["loss"]), rtol=LOSS_RTOL)
    keys = sorted(want)
    rel = _rel_l2(torch.cat([got[k].reshape(-1) for k in keys]).numpy(),
                  torch.cat([want[k].reshape(-1) for k in keys]).numpy())
    assert rel <= GRAD_REL_L2, rel


def test_bf16_step_repeats_bit_for_bit(jax_models):
    # the fault of a PoseNet head gradient that read garbage at random:
    # two steps from the same weights give the same bits, every leaf
    batch = _batch(2)
    loss_a, a = _port_step(jax_models, batch)
    loss_b, b = _port_step(jax_models, batch)
    assert loss_a == loss_b
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]


def test_posenet_s_one_column_conv_has_a_steady_bf16_weight_gradient():
    # PoseNet at 32x64: conv7's input is 1x1. Six backward passes under
    # bf16 autocast give the same bits, within one bf16 rounding-scale of
    # the same step with oneDNN off (torch's own bf16 convolution)
    gen = torch.Generator().manual_seed(21)
    pose = build_model("PoseNet", generator=gen, device="cpu")
    frames = [torch.randn(2, 3, HEIGHT, WIDTH, generator=gen) for _ in range(3)]

    def conv7_grad():
        pose.zero_grad()
        with torch.autocast("cpu", torch.bfloat16):
            out = pose(frames[0], frames[1:])
        out.float().square().sum().backward()
        return pose.conv7[0].weight.grad.clone()

    grads = [conv7_grad() for _ in range(6)]
    with torch.backends.mkldnn.flags(enabled=False):
        ref = conv7_grad()
    assert all(torch.equal(g, grads[0]) for g in grads)
    assert _rel_l2(grads[0].numpy(), ref.numpy()) <= 1e-2
