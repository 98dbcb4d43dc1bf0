"""Port parity for the training slice: the plain versions of the backward
kernels (A′, the warp's grid gradient; C, the SSIM backward), the autograd
Functions around the kernels, the loss gradients, one full train step
(with and without gradient accumulation) and the optimizer, against the
JAX package on the same numpy inputs and the same weights.

Images are NHWC on the JAX side and NCHW on the port's. The inputs avoid
exact ties (no identical windows, no raw SSIM distance of 0 or 1, no
x == y, no sample position within 1e-3 px of a pixel), where the two
packages' tie rules are documented rather than compared. The full step
runs DispResNet-18 + PoseNet(s2d_convs=0) at 64x96, batch 2, fp32.

The step's gradient is piecewise smooth: it jumps where a warp sample
crosses a pixel, where the automask minimum or an |.| changes side, and it
is steep in flat SSIM windows. Two fp32 implementations agree to ~1e-7 in
the forward, and a pixel that sits within that distance of a jump takes
the other side in one of them. At 64x96 a 1e-7 relative perturbation of
the weights moves single keys of the port's own gradient by up to 1e-2
(measured on the CPU). The step tests therefore fix their batches and
give the pose head a bias, so that the warp is not the near-identity of
a fresh initialization (where every sample sits next to a jump), and run
the loss without depth_norm: with it, the loss is nearly invariant to a
shift of the disparity head's bias, whose gradient is then a near-zero
difference of large terms. depth_norm's gradient is compared in
test_loss_gradients_match_jax.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu.losses import total as jax_total
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.ops import resample as jax_resample
from unsupervised_pseuso_lidar_tpu.ops.pallas.photometric import ssim_bwd_pallas
from unsupervised_pseuso_lidar_tpu.ops.ssim import ssim_distance as jax_ssim
from unsupervised_pseuso_lidar_tpu.train import config as jax_config
from unsupervised_pseuso_lidar_tpu.train.trainer import TrainState as JaxTrainState
from unsupervised_pseuso_lidar_tpu.train.trainer import make_optimizer as jax_make_optimizer
from unsupervised_pseuso_lidar_tpu.train.trainer import make_train_step_body
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.eval import metrics as metrics_module
from unsupervised_pseuso_lidar_tpu_torch.losses import total
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.ops import resample, ssim
from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.train import config
from unsupervised_pseuso_lidar_tpu_torch.train import trainer as trainer_module
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(31)
HEIGHT, WIDTH = 64, 96
CONFIG = "configs/tpu_v5e.yaml"
# the training objective of configs/tpu_v5e.yaml, exact warp on both sides
LOSS_SETTINGS = dict(smooth_weight=0.001, smooth_on="disp", depth_norm=True)
# the full-step tests: the same without depth_norm (module docstring)
STEP_SETTINGS = dict(LOSS_SETTINGS, depth_norm=False)
# relative to the gradient's largest entry: dx of the SSIM grows as
# 1/(c·d) in flat windows, so no absolute bound holds
BWD_RTOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _assert_close_to_max(got, ref, rtol=BWD_RTOL):
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    norm = np.linalg.norm(ref)
    return np.linalg.norm(got - ref) / norm if norm else np.linalg.norm(got)


# --------------------------------------------------------------------------
# (a) the warp's grid gradient, (b) the autograd Functions
# --------------------------------------------------------------------------


def _off_pixel_grid(batch, height, width, lo, hi, rng=RNG):
    """Normalized sample coordinates whose pixel positions lie in [lo, hi)
    (in units of the image size) and at least 1e-3 px from an integer,
    where the bilinear gradient jumps."""
    def axis(size):
        whole = rng.integers(int(np.floor(lo * size)), int(np.ceil(hi * size)),
                             (batch, height, width))
        pixel = whole + rng.uniform(1e-3, 1.0 - 1e-3, whole.shape)
        return pixel / max(size - 1, 1) * 2.0 - 1.0
    return np.stack([axis(width), axis(height)], -1).astype(np.float32)


GRID_CASES = {
    "inside": lambda: _off_pixel_grid(2, 12, 20, 0.0, 0.95),
    # out of frame by up to 2 images: partial taps, and every tap outside
    "out_of_frame": lambda: _off_pixel_grid(2, 12, 20, -1.0, 2.0),
    # far outside, where the port clamps before the floor
    "huge": lambda: np.where(
        RNG.uniform(size=(2, 12, 20, 2)) < 0.3,
        RNG.choice([-1e7, -40.0, 3.0, 1e9], (2, 12, 20, 2)),
        _off_pixel_grid(2, 12, 20, 0.0, 0.95),
    ).astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_sample_grad_grid_matches_jax_vjp(case):
    # the plain version of A′ vs jax.vjp of the JAX gather warp w.r.t. the
    # grid: max abs err <= 1e-5 · max|d_grid|
    img = RNG.uniform(0, 1, (2, 12, 20, 3)).astype(np.float32)
    grid = GRID_CASES[case]()
    g = RNG.normal(size=(2, 12, 20, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda gr: jax_resample.grid_sample(jnp.asarray(img), gr),
                     jnp.asarray(grid))
    (ref,) = vjp(jnp.asarray(g))
    got = resample.grid_sample_grad_grid(_nchw(img), torch.from_numpy(grid), _nchw(g))
    assert got.shape == grid.shape
    _assert_close_to_max(got.numpy(), np.asarray(ref))


def test_warp_function_passes_gradcheck():
    # the autograd Function on the CPU (kernel A's and A′'s plain versions)
    # against numerical differences of the plain forward, float64
    img = torch.from_numpy(RNG.uniform(0, 1, (2, 3, 5, 7)))
    grid = torch.from_numpy(
        _off_pixel_grid(2, 5, 7, -0.3, 1.2).astype(np.float64)
    ).requires_grad_()
    assert torch.autograd.gradcheck(kernels.warp_bilinear, (img, grid))


@pytest.mark.parametrize("ssim_weight", [1.0, 0.85])
def test_photometric_function_passes_gradcheck(ssim_weight):
    # kernel B's and C's plain versions behind the Function, both inputs
    # differentiated (no ties: independent uniform images)
    x = torch.from_numpy(RNG.uniform(0, 1, (1, 2, 5, 6))).requires_grad_()
    y = torch.from_numpy(RNG.uniform(0, 1, (1, 2, 5, 6))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: kernels.photometric(a, b, ssim_weight), (x, y)
    )


# --------------------------------------------------------------------------
# (c) the SSIM backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 2, 9, 2), (1, 7, 2, 1)])
def test_photometric_map_bwd_matches_pallas(shape):
    # the plain version of C vs the JAX kernel in interpret mode (the SSIM
    # distance alone; the JAX kernel needs dims >= 2)
    x = RNG.uniform(0, 1, shape).astype(np.float32)
    y = RNG.uniform(0, 1, shape).astype(np.float32)
    g = RNG.normal(size=shape).astype(np.float32)
    ref_dx, ref_dy = ssim_bwd_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(g),
                                     interpret=True)
    dx, dy = ssim.photometric_map_bwd(_nchw(x), _nchw(y), _nchw(g), 1.0)
    _assert_close_to_max(_nhwc(dx), np.asarray(ref_dx))
    _assert_close_to_max(_nhwc(dy), np.asarray(ref_dy))


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 1, 9, 2), (1, 2, 5, 3), (1, 6, 1, 1)])
@pytest.mark.parametrize("ssim_weight", [1.0, 0.85])
def test_photometric_map_bwd_matches_jax_vjp(shape, ssim_weight):
    # vs jax.vjp of ssim_distance + the L1 term of the blend (jnp.abs'
    # rule), 1- and 2-pixel dimensions included
    x = RNG.uniform(0, 1, shape).astype(np.float32)
    y = RNG.uniform(0, 1, shape).astype(np.float32)
    g = RNG.normal(size=shape).astype(np.float32)

    def blend(a, b):
        out = jax_ssim(a, b)
        if ssim_weight < 1.0:
            out = ssim_weight * out + (1.0 - ssim_weight) * jnp.abs(b - a)
        return out

    _, vjp = jax.vjp(blend, jnp.asarray(x), jnp.asarray(y))
    ref_dx, ref_dy = vjp(jnp.asarray(g))
    for need_dx, need_dy in ((True, True), (True, False)):
        dx, dy = ssim.photometric_map_bwd(_nchw(x), _nchw(y), _nchw(g), ssim_weight,
                                          need_dx, need_dy)
        _assert_close_to_max(_nhwc(dx), np.asarray(ref_dx))
        if need_dy:
            _assert_close_to_max(_nhwc(dy), np.asarray(ref_dy))
        else:
            assert dy is None


def test_photometric_map_bwd_tie_rules():
    # the JAX kernel's rules: identical flat windows (raw == 0 exactly)
    # pass no SSIM gradient, and the L1 term at y == x takes jnp.abs'
    # branch: dx = -(1 - w)·g, dy = +(1 - w)·g
    x = torch.full((1, 1, 6, 7), 0.5)
    g = torch.from_numpy(RNG.normal(size=(1, 1, 6, 7)).astype(np.float32))
    dx, dy = ssim.photometric_map_bwd(x, x.clone(), g, 1.0)
    assert float(dx.abs().max()) == 0.0 and float(dy.abs().max()) == 0.0
    dx, dy = ssim.photometric_map_bwd(x, x.clone(), g, 0.85)
    torch.testing.assert_close(dx, -(1.0 - 0.85) * g, rtol=0, atol=0)
    torch.testing.assert_close(dy, (1.0 - 0.85) * g, rtol=0, atol=0)


# --------------------------------------------------------------------------
# (d) the loss gradients
# --------------------------------------------------------------------------


def test_loss_gradients_match_jax():
    # d(reproj + smooth)/d(disparities, poses) with the training settings
    # (min, smoothness on disparity at 0.001, depth_norm, bidirectional)
    # vs jax.grad of the JAX total_loss with the exact gather warp: rel L2
    # <= 1e-4 per input
    batch, height, width = 2, 24, 40
    k = np.array([[40.0, 0, 20.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([np.sin(xx * 0.3 + c) * np.cos(yy * 0.2 - c) for c in range(3)], -1)
    tgt, ref0, ref1 = (
        (base + RNG.normal(0, 0.05, (batch, height, width, 3))).astype(np.float32)
        for _ in range(3)
    )
    disps = [RNG.uniform(0.05, 0.9, (batch, height, width, 1)).astype(np.float32)
             for _ in range(2)]
    poses = np.concatenate([RNG.normal(0, 0.01, (batch, 2, 3)),
                            RNG.normal(0, 0.1, (batch, 2, 3))], -1).astype(np.float32)
    intr = np.broadcast_to(k, (batch, 3, 3)).copy()

    def jax_loss(d_tgt, d_ref0, pose):
        reproj, smooth = jax_total.total_loss(
            jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)],
            [[d_tgt], [d_ref0]], pose, jnp.asarray(intr), mode="min",
            warp_impl="gather", **LOSS_SETTINGS,
        )
        return reproj + smooth

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(disps[0]), jnp.asarray(disps[1]), jnp.asarray(poses)
    )
    leaves = [_nchw(disps[0]).requires_grad_(), _nchw(disps[1]).requires_grad_(),
              torch.from_numpy(poses).requires_grad_()]
    reproj, smooth, _ = total.total_loss(
        _nchw(tgt), [_nchw(ref0), _nchw(ref1)], [[leaves[0]], [leaves[1]]],
        leaves[2], torch.from_numpy(intr), mode="min", **LOSS_SETTINGS,
    )
    got = torch.autograd.grad(reproj + smooth, leaves)
    got = [_nhwc(got[0]), _nhwc(got[1]), got[2].numpy()]
    for name, a, b in zip(("disp_tgt", "disp_ref0", "poses"), got, ref):
        assert float(np.abs(b).max()) > 0, name
        assert _rel_l2(a, b) <= 1e-4, (name, _rel_l2(a, b))


# --------------------------------------------------------------------------
# (e, g) the train step, (f) the optimizer
# --------------------------------------------------------------------------


def _grads_in_opt_state():
    """An optax transformation that applies no update and keeps the
    gradients it was given as its state, so the JAX step hands them out."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


@pytest.fixture(scope="module")
def jax_models():
    """Flax DispResNet-18 + PoseNet(s2d_convs=0) variables (numpy), with
    non-trivial BatchNorm running statistics and a pose head bias that
    moves the warp by a few pixels (module docstring)."""
    depth = jax_build_model("DispResNet")
    pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    dv = jax.jit(partial(depth.init, train=False))(jax.random.PRNGKey(0), img)
    pv = jax.jit(pose.init)(jax.random.PRNGKey(1), img, [img, img])
    params = {"depth": jax.tree.map(np.asarray, dv["params"]),
              "pose": jax.tree.map(np.asarray, pv["params"])}
    rng = np.random.default_rng(5)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, dv["batch_stats"]))
    # poses ~ (0.005 rad, 0.03) per axis after PoseNet's 0.06 output scale
    head = params["pose"]["TorchConv_7"]["Conv_0"]
    head["bias"] = (rng.normal(size=(2, 6)) * np.array([0.005] * 3 + [0.03] * 3)
                    / 0.06).reshape(-1).astype(np.float32)
    return depth, pose, params, stats


def _jax_step(jax_models, batch, accum_steps, start_step=0, **step_kwargs):
    depth, pose, params, stats = jax_models
    tx = _grads_in_opt_state()
    body = make_train_step_body(depth, pose, tx, loss_mode="min", warp_impl="gather",
                                accum_steps=accum_steps, **STEP_SETTINGS, **step_kwargs)
    state = JaxTrainState(step=jnp.asarray(start_step, jnp.int32), params=params,
                          batch_stats={"depth": stats, "pose": {}},
                          opt_state=tx.init(params))
    jax_batch = {k: jnp.asarray(batch[k]) for k in
                 ("tgt", "ref_imgs", "intrinsics", "oxts", "groundtruth")}
    new_state, metrics = jax.jit(body)(state, jax_batch)
    return new_state, metrics


def _port_step(jax_models, batch, accum_steps, start_step=0, **step_kwargs):
    _, _, params, stats = jax_models
    depth = build_model("DispResNet", device="cpu")
    depth.load_state_dict(state_dict_from_jax(params["depth"], stats, "DispResNet"))
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(state_dict_from_jax(params["pose"], {}, "PoseNet"))
    cfg = config.load_config(CONFIG)
    optimizer = make_optimizer(cfg, depth, pose)
    state = TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))
    step = make_train_step(state, device="cpu", loss_mode="min",
                           accum_steps=accum_steps, **STEP_SETTINGS, **step_kwargs)
    state.step = start_step
    metrics = step(batch)
    assert state.step == start_step + 1
    return depth, pose, metrics


def _compare_steps(jax_models, batch_size, accum_steps, seed, oxts=None, start_step=0,
                   **step_kwargs):
    # loss rel 1e-4 (the eval step's tolerance); every gradient per
    # state-dict key at rel L2 <= 1e-3, and the median key at 1e-4;
    # BatchNorm running statistics after the step at 1e-5. The port's
    # automask_keep has no JAX counterpart with the gather warp (JAX
    # reports it beside the banded warp's coverage; see test_losses). Both
    # steps start at optimizer step `start_step`
    batch = next(SyntheticTripletDataset(1, batch_size, HEIGHT, WIDTH, seed=seed,
                                         uint8_images=True).batches())
    if oxts is not None:
        batch["oxts"] = oxts.astype(np.float32)
    new_state, ref = _jax_step(jax_models, batch, accum_steps, start_step, **step_kwargs)
    depth, pose, got = _port_step(jax_models, batch, accum_steps, start_step, **step_kwargs)

    assert sorted(ref) == sorted(["loss", "mul_app_loss", "smoothness_loss"]
                                 + (["supervised_loss"] if step_kwargs.get("supervised_weight")
                                    else []))
    assert sorted(got) == sorted([*ref, "automask_keep"])
    assert 0.0 < float(got["automask_keep"]) <= 1.0
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-4,
                                   err_msg=key)
    grads = jax.tree.map(np.asarray, new_state.opt_state)
    worst = (0.0, None)
    rels = []
    for name, model in (("DispResNet", depth), ("PoseNet", pose)):
        ref_grads = state_dict_from_jax(grads["depth" if name == "DispResNet" else "pose"],
                                        None, name)
        params = dict(model.named_parameters())
        assert sorted(ref_grads) == sorted(params)
        for key, ref_grad in ref_grads.items():
            grad = params[key].grad
            grad = torch.zeros_like(ref_grad) if grad is None else grad
            rel = _rel_l2(grad.numpy(), ref_grad.numpy())
            rels.append(rel)
            worst = max(worst, (rel, f"{name}:{key}"), key=lambda w: w[0])
    print(f"worst gradient: {worst[1]} at rel L2 {worst[0]:.3g}; "
          f"median {np.median(rels):.3g}")
    assert worst[0] <= 1e-3, worst
    assert np.median(rels) <= 1e-4, np.median(rels)

    new_stats = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params["depth"]),
                                    jax.tree.map(np.asarray, new_state.batch_stats["depth"]),
                                    "DispResNet")
    buffers = dict(depth.named_buffers())
    for key, value in new_stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[key].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    return depth, pose


def test_train_step_matches_jax(jax_models):
    _compare_steps(jax_models, batch_size=2, accum_steps=1, seed=1)


def test_semi_supervised_train_step_matches_jax(jax_models):
    # semi_sup_pose: the batch's OXTS poses replace the pose net's, which
    # then gets no gradient (JAX: zeros; the port: none) and does not move.
    # The poses are drawn at the pose head's scale (jax_models): the
    # synthetic scene's 0.3 m baseline would push every sample out of frame
    # at the ~0.2 m depths of a fresh disparity head, leaving no
    # photometric gradient to compare
    oxts = (np.random.default_rng(6).normal(size=(2, 2, 6))
            * np.array([0.005] * 3 + [0.03] * 3))
    _, pose = _compare_steps(jax_models, batch_size=2, accum_steps=1, seed=3,
                             oxts=oxts, semi_sup_pose=True)
    assert all(p.grad is None for p in pose.parameters())
    _, _, params, _ = jax_models
    for key, value in state_dict_from_jax(params["pose"], {}, "PoseNet").items():
        assert torch.equal(pose.state_dict()[key], value), key


def test_accumulated_train_step_matches_jax(jax_models):
    # accum_steps 2 over batch 4: two micro-batches of 2, gradients summed
    # then averaged, BatchNorm statistics carried from the first to the
    # second
    _compare_steps(jax_models, batch_size=4, accum_steps=2, seed=2)


def test_supervised_train_step_matches_jax(jax_models):
    # the sparse-LiDAR term on the synthetic batch's dense groundtruth,
    # its value reported as supervised_loss
    _compare_steps(jax_models, batch_size=2, accum_steps=1, seed=1, supervised_weight=0.1)


def test_supervised_term_gradient_at_a_tie_matches_jax():
    # pred == gt exactly at one valid pixel: jnp.abs' rule gives +1 there
    # (torch.abs would give 0), one invalid pixel (gt 0) gives nothing;
    # d/d(disp) equal to jax.grad of JAX's expression (train/trainer.py)
    from unsupervised_pseuso_lidar_tpu.geometry.warp import disp_to_depth as jax_disp_to_depth

    disp = RNG.uniform(0.05, 0.9, (2, 1, 3, 4)).astype(np.float32)
    gt = RNG.uniform(1.0, 50.0, (2, 3, 4)).astype(np.float32)
    gt[0, 1, 2] = np.float32(1.0) / (np.float32(10.0) * disp[0, 0, 1, 2] + np.float32(0.01))
    gt[1, 0, 0] = 0.0

    def jax_term(d):
        pred = jax_disp_to_depth(d[:, 0])
        valid = (jnp.asarray(gt) > 1e-3).astype(jnp.float32)
        return jnp.sum(jnp.abs(pred - gt) * valid) / jnp.maximum(valid.sum(), 1.0)

    ref = np.asarray(jax.grad(jax_term)(jnp.asarray(disp)))
    leaf = torch.from_numpy(disp).requires_grad_()
    sup = trainer_module.supervised_loss(leaf, torch.from_numpy(gt))
    (got,) = torch.autograd.grad(sup, leaf)
    pred = 1.0 / (10.0 * leaf.detach() + 0.01)
    assert float(pred[0, 0, 1, 2]) == float(gt[0, 1, 2])  # the tie is exact
    assert float(got[0, 0, 1, 2]) != 0.0 and float(got[1, 0, 0, 0]) == 0.0
    np.testing.assert_allclose(float(sup.detach()), float(jax_term(jnp.asarray(disp))), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("warmup", [1000, 300, 7, 12345])
def test_automask_warmup_scale_matches_jax(warmup):
    # JAX's expression (train/trainer.py make_train_step_body) jitted over
    # steps 0..warmup+2, against the port's host computation: every step
    # bit for bit
    @jax.jit
    def jax_scale(step_idx):
        ramp = jnp.clip(step_idx.astype(jnp.float32) / warmup, 0.0, 1.0)
        return 10.0 ** (4.0 * (1.0 - ramp))

    steps = np.arange(warmup + 3)
    ref = np.asarray(jax_scale(jnp.asarray(steps, jnp.int32)))
    got = np.array([trainer_module.automask_ident_scale(int(s), warmup) for s in steps],
                   np.float32)
    differ = [int(s) for s in steps[got != ref]]
    assert not differ, differ
    assert got[0] == 1e4 and got[-1] == 1.0


def test_mid_warmup_train_step_matches_jax(jax_models):
    # the 'min' objective at step 5 of a 10-step automask warm-up: the
    # identity term scaled by 10 ** 2
    _compare_steps(jax_models, batch_size=2, accum_steps=1, seed=1, start_step=5,
                   automask_warmup=10)


@pytest.mark.parametrize("pose_lr", [1e-3, 3e-4])
def test_adam_and_step_lr_match_optax(pose_lr):
    # identical gradients for 5 steps through a StepLR boundary every 2
    # steps (step_size 2 epochs of 1 step): params at 1e-6; two param
    # groups when depth_lr != pose_lr
    raw = {"optimizer": {"name": "Adam", "depth": {"lr": 1e-3}, "pose": {"lr": pose_lr}},
           "scheduler": {"name": "StepLR", "step_size": 2, "gamma": 0.1}}
    jax_cfg = jax_config.Config.from_dict({"action": raw})
    cfg = config.Config.from_dict({"action": raw})
    depth, pose = nn.Linear(4, 3), nn.Linear(2, 5)
    params = {"depth": {n: p.detach().numpy().copy() for n, p in depth.named_parameters()},
              "pose": {n: p.detach().numpy().copy() for n, p in pose.named_parameters()}}
    tx = jax_make_optimizer(jax_cfg, steps_per_epoch=1)
    jax_params = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jax_params)
    optimizer = make_optimizer(cfg, depth, pose)
    assert len(optimizer.param_groups) == (1 if pose_lr == 1e-3 else 2)
    scheduler = make_lr_schedule(optimizer, 2, 0.1, steps_per_epoch=1)
    rng = np.random.default_rng(8)
    for _ in range(5):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state,
                                       jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for net, module in (("depth", depth), ("pose", pose)):
            for n, p in module.named_parameters():
                p.grad = torch.from_numpy(grads[net][n])
        optimizer.step()
        scheduler.step()
        for net, module in (("depth", depth), ("pose", pose)):
            for n, p in module.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jax_params[net][n]),
                                           rtol=0, atol=1e-6, err_msg=f"{net}.{n}")


def test_trainer_runs_epochs_on_the_cpu():
    # the entry point end to end at a small size: run_epoch counts optimizer
    # steps and changes every parameter with a gradient (not the unused
    # scale 1-3 disparity heads) and records its waits for batches,
    # validate averages the eval step, the wrappers launch nothing on the
    # CPU, and hflip with semi_sup_pose is refused
    cfg = config.load_config(CONFIG)
    cfg.datasets.augmentation.image_height, cfg.datasets.augmentation.image_width = 32, 64
    cfg.action.batch_size, cfg.action.precision = 2, "fp32"
    data = SyntheticTripletDataset(2, 2, 32, 64, seed=0, uint8_images=True)
    logged = []
    cfg.action.log_freq = 1
    trainer = Trainer(cfg, data, log_fn=lambda m, step: logged.append(step), device="cpu")
    params = dict(trainer.state.depth_model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    kernels.reset_launch_counts()
    metrics = trainer.run_epoch(data.batches())
    assert trainer.state.step == 2 and logged == [1, 2]
    assert sorted(metrics) == ["automask_keep", "loss", "mul_app_loss", "smoothness_loss"]
    assert all(np.isfinite(v) for v in metrics.values())
    unchanged = sorted(k for k, p in params.items() if torch.equal(before[k], p))
    assert unchanged == [f"decoder.decoder.{i}.conv.{n}" for i in (11, 12, 13)
                         for n in ("bias", "weight")]
    # the synthetic batches carry groundtruth: validate adds the depth
    # metrics (eval_pose is off in this config, so no pose metrics)
    val = trainer.validate(data.batches())
    assert sorted(val) == sorted(["loss", *metrics_module.METRICS])
    assert all(np.isfinite(v) for v in val.values())
    assert kernels.launch_counts == dict.fromkeys(kernels.KERNELS, 0)
    assert len(trainer.batch_waits) == 2 and min(trainer.batch_waits) >= 0.0
    # the config refuses what cannot be combined: a flip with OXTS poses
    bad = config.load_config(CONFIG)
    bad.datasets.augmentation.hflip = bad.action.semi_sup_pose = True
    with pytest.raises(ValueError, match="hflip"):
        bad.validate()
