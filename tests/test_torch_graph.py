"""The step as one program (train/graph.py): what the CPU can check of the
CUDA graphs of TrainStep, make_multi_step and EvalStep.

A CUDA graph runs only on the card (tests/test_torch_cuda.py holds the
captured steps against the eager ones there). Here: the host values the
graph reads as tensors (the automask warm-up scale, the learning rate)
keep their bits; the body a graph captures, run eagerly on its static
buffers refilled at each step (StepGraphs with capture=False), equals the
eager step bit for bit; the port's make_multi_step equals JAX's lax.scan
of the step; graph=True is refused where capture does not apply; where
nothing is captured StepGraphs runs the body as it is, and the train
step counts its saved bytes once a signature; and a graph's launches are
counted once a replay.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (  # noqa: F401 (jax_models is a fixture)
    CONFIG,
    HEIGHT,
    STEP_SETTINGS,
    WIDTH,
    _grads_in_opt_state,
    _rel_l2,
    jax_models,
)
from torch import nn

from unsupervised_pseuso_lidar_tpu.train.trainer import TrainState as JaxTrainState
from unsupervised_pseuso_lidar_tpu.train.trainer import make_multi_step as jax_make_multi_step
from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.models.layers import BatchNorm2d
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import make_mesh
from unsupervised_pseuso_lidar_tpu_torch.train import config
from unsupervised_pseuso_lidar_tpu_torch.train.graph import StepGraphs, graph_enabled
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    BN_ONE_PASS,
    SAVED_BYTES,
    EvalStep,
    Trainer,
    TrainState,
    automask_ident_scale,
    learning_rates,
    make_eval_step,
    make_lr_schedule,
    make_multi_step,
    make_optimizer,
    make_train_step,
)
from unsupervised_pseuso_lidar_tpu_torch.utils import profiling
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _linear_state(pose_lr=1e-3, step_size=2):
    raw = {"optimizer": {"name": "Adam", "depth": {"lr": 1e-3}, "pose": {"lr": pose_lr}},
           "scheduler": {"name": "StepLR", "step_size": step_size, "gamma": 0.1}}
    cfg = config.Config.from_dict({"action": raw})
    gen = torch.Generator().manual_seed(4)
    depth, pose = nn.Linear(4, 3), nn.Linear(2, 5)
    with torch.no_grad():
        for p in [*depth.parameters(), *pose.parameters()]:
            p.copy_(torch.randn(p.shape, generator=gen))
    optimizer = make_optimizer(cfg, depth, pose)
    return TrainState(depth, pose, optimizer,
                      make_lr_schedule(optimizer, step_size, 0.1, steps_per_epoch=1))


@pytest.mark.parametrize("warmup", [10, 1000, 7])
def test_warmup_scale_tensor_has_the_float_and_jax_bits(warmup):
    # the 0-dim fp32 tensor a graph reads at steps 0, 1, w/2, w-1, w, w+1:
    # the host float's bits and JAX's jitted expression's
    @jax.jit
    def jax_scale(step_idx):
        ramp = jnp.clip(step_idx.astype(jnp.float32) / warmup, 0.0, 1.0)
        return 10.0 ** (4.0 * (1.0 - ramp))

    step = make_train_step(_linear_state(), device="cpu", loss_mode="min",
                           automask_warmup=warmup)
    for s in (0, 1, warmup // 2, warmup - 1, warmup, warmup + 1):
        got = step.host_values(s, 2)["ident_scale"]
        assert got.dtype == torch.float32 and got.ndim == 0
        want = np.float32(automask_ident_scale(s, warmup))
        assert got.numpy().tobytes() == want.tobytes(), s
        assert got.numpy().tobytes() == np.asarray(jax_scale(jnp.int32(s))).tobytes(), s
    # no warm-up, or another objective: exactly 1
    plain = make_train_step(_linear_state(), device="cpu", loss_mode="mean",
                            automask_warmup=warmup)
    assert float(plain.host_values(0, 2)["ident_scale"]) == 1.0


@pytest.mark.parametrize("pose_lr", [1e-3, 3e-4])
def test_tensor_learning_rate_under_step_lr_matches_the_float(pose_lr):
    # Adam through a StepLR boundary every 2 steps, 5 steps: the learning
    # rates written into a tensor for each step (host_values, learning_rates)
    # give the float learning rates' parameters bit for bit on the CPU
    floats, tensors = _linear_state(pose_lr), _linear_state(pose_lr)
    step = make_train_step(tensors, device="cpu")
    for i in range(5):
        for state in (floats, tensors):
            g = torch.Generator().manual_seed(100 + i)
            for p in [*state.depth_model.parameters(), *state.pose_model.parameters()]:
                p.grad = torch.randn(p.shape, generator=g)
        floats.optimizer.step()
        lr = step.host_values(i, 1)["lr"]
        assert lr.shape == (len(tensors.optimizer.param_groups),)
        with learning_rates(tensors.optimizer, lr):
            tensors.optimizer.step()
        assert all(isinstance(g["lr"], float) for g in tensors.optimizer.param_groups)
        for state in (floats, tensors):
            state.scheduler.step()
        for a, b in zip([*floats.depth_model.parameters(), *floats.pose_model.parameters()],
                        [*tensors.depth_model.parameters(), *tensors.pose_model.parameters()]):
            assert torch.equal(a, b), i


def _small_trainer(**overrides):
    cfg = config.load_config(CONFIG)
    cfg.datasets.augmentation.image_height, cfg.datasets.augmentation.image_width = 32, 64
    cfg.action.batch_size, cfg.action.precision = 2, "fp32"
    cfg.action.log_freq = 1000
    aug = {k: overrides.pop(k) for k in ("color_jitter", "hflip") if k in overrides}
    for k, v in aug.items():
        setattr(cfg.datasets.augmentation, k, v)
    for k, v in overrides.items():
        setattr(cfg.action, k, v)
    return Trainer(cfg, device="cpu", graph=False)


STEP_ARGS = ("loss_mode", "semi_sup_pose", "smooth_weight", "smooth_on", "depth_norm",
             "automask_warmup", "no_ssim", "min_bidirectional", "supervised_weight",
             "accum_steps", "remat", "color_jitter", "hflip", "aug_seed", "precision",
             "with_coverage")


def _state_tensors(trainer):
    state = trainer.state
    out = {f"depth.{k}": v for k, v in state.depth_model.state_dict().items()}
    out.update({f"pose.{k}": v for k, v in state.pose_model.state_dict().items()})
    for net, model in (("depth", state.depth_model), ("pose", state.pose_model)):
        out.update({f"{net}.{k}.grad": p.grad for k, p in model.named_parameters()
                    if p.grad is not None})
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in slots.items()})
    return out


@pytest.mark.parametrize("overrides", [
    {"loss_mode": "min"},
    {"loss_mode": "mean"},
    {"loss_mode": "ssim"},
    {"loss_mode": "min", "color_jitter": True, "hflip": True},
    {"loss_mode": "min", "automask_warmup": 2},
    {"loss_mode": "min", "accum_steps": 2},
    {"loss_mode": "min", "remat": True},
], ids=["min", "mean", "ssim", "jitter_flip", "warmup_crossing", "accum2", "remat"])
def test_captured_body_matches_the_eager_step(overrides):
    # two Trainers from one seed: one eager, one whose train step runs its
    # body through StepGraphs(capture=False) — the first call eager, the
    # later ones on the static buffers refilled from each batch and step's
    # host values, what a CUDA graph replays. 3 steps: metrics, parameters,
    # gradients, BatchNorm statistics and Adam's slots equal bit for bit
    eager, static = _small_trainer(**dict(overrides)), _small_trainer(**dict(overrides))
    static.train_step.graphs = StepGraphs(CPU, capture=False)
    batches = list(SyntheticTripletDataset(3, 2, 32, 64, seed=11, uint8_images=True).batches())
    for i, batch in enumerate(batches):
        got = static.train_step(batch)
        want = eager.train_step(batch)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        a, b = _state_tensors(static), _state_tensors(eager)
        assert sorted(a) == sorted(b)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        assert not differ, (i, differ[:5])
    # one signature: the first call ran eagerly, the others on its buffers
    assert len(static.train_step.graphs.graphs) == 1
    assert static.state.step == eager.state.step == 3


def test_captured_eval_body_matches_the_eager_step():
    # EvalStep's body on static buffers vs the eager step over 3 batches
    # with the Eigen protocol and pose metrics: every metric and
    # depth_pred bit for bit
    trainer = _small_trainer(loss_mode="min")
    kwargs = dict(loss_mode="min", eval_protocol="eigen", pose_metrics=True, device="cpu")
    eager = make_eval_step(trainer.state.depth_model, trainer.state.pose_model, graph=False,
                           **kwargs)
    static = EvalStep(trainer.state.depth_model, trainer.state.pose_model, graph=False,
                      **kwargs)
    static.graphs = StepGraphs(CPU, capture=False)
    for batch in SyntheticTripletDataset(3, 2, 32, 64, seed=12, uint8_images=True).batches():
        (got, got_depth), (want, want_depth) = static(batch), eager(batch)
        assert sorted(got) == sorted(want) and "pose_ate" in got and "abs_rel" in got
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert torch.equal(got_depth, want_depth)


def test_multi_step_matches_jax_scan(jax_models):
    # 3 'min' steps in one body (the port's make_multi_step) vs JAX's
    # make_multi_step (lax.scan of the step) from optimizer step 3 of a
    # 10-step automask warm-up: the port's Adam at lr 0 and JAX's
    # transformation that applies no update keep the weights fixed, so the
    # last step's metrics and gradients compare at the one-step tests'
    # tolerances (the last batch and step are
    # test_mid_warmup_train_step_matches_jax's), the BatchNorm running
    # statistics after 3 updates at 1e-5
    depth, pose, params, stats = jax_models
    per_step = [next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=seed,
                                             uint8_images=True).batches())
                for seed in (2, 3, 1)]
    keys = ("tgt", "ref_imgs", "intrinsics", "oxts", "groundtruth")
    batches = {k: np.stack([b[k] for b in per_step]) for k in keys}

    tx = _grads_in_opt_state()
    multi = jax_make_multi_step(depth, pose, tx, 3, donate=False, loss_mode="min",
                                warp_impl="gather", automask_warmup=10, **STEP_SETTINGS)
    state = JaxTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                          batch_stats={"depth": stats, "pose": {}}, opt_state=tx.init(params))
    new_state, ref = multi(state, {k: jnp.asarray(v) for k, v in batches.items()})

    cfg = config.load_config(CONFIG)
    cfg.action.optimizer.depth_lr = cfg.action.optimizer.pose_lr = 0.0
    depth_t = build_model("DispResNet", device="cpu")
    depth_t.load_state_dict(state_dict_from_jax(params["depth"], stats, "DispResNet"))
    pose_t = build_model("PoseNet", device="cpu")
    pose_t.load_state_dict(state_dict_from_jax(params["pose"], {}, "PoseNet"))
    before = {k: v.clone() for k, v in depth_t.state_dict().items()}
    optimizer = make_optimizer(cfg, depth_t, pose_t)
    port_state = TrainState(depth_t, pose_t, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))
    port_state.step = 3
    got = make_multi_step(port_state, 3, device="cpu", loss_mode="min", automask_warmup=10,
                          **STEP_SETTINGS)(batches)
    assert port_state.step == 6

    for key in ("loss", "mul_app_loss", "smoothness_loss"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-4, err_msg=key)
    grads = jax.tree.map(np.asarray, new_state.opt_state)
    rels = []
    for name, model, net in (("DispResNet", depth_t, "depth"), ("PoseNet", pose_t, "pose")):
        ref_grads = state_dict_from_jax(grads[net], None, name)
        named = dict(model.named_parameters())
        for key, ref_grad in ref_grads.items():
            grad = named[key].grad
            grad = torch.zeros_like(ref_grad) if grad is None else grad
            rels.append((_rel_l2(grad.numpy(), ref_grad.numpy()), f"{name}:{key}"))
    assert max(rels)[0] <= 1e-3, max(rels)
    assert np.median([r for r, _ in rels]) <= 1e-4
    new_stats = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params["depth"]),
                                    jax.tree.map(np.asarray, new_state.batch_stats["depth"]),
                                    "DispResNet")
    buffers = dict(depth_t.named_buffers())
    for key, value in new_stats.items():
        if key.endswith(("running_mean", "running_var")):
            assert not torch.equal(buffers[key], before[key]), key
            np.testing.assert_allclose(buffers[key].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    for key, param in depth_t.named_parameters():
        assert torch.equal(param.detach(), before[key]), key


def test_multi_step_body_equals_single_steps():
    # make_multi_step's one body over [3, B, ...] with its [3] slots of
    # host values (a warm-up crossing and a StepLR boundary inside the 3
    # steps, jitter and flips) vs 3 calls of the train step, both through
    # StepGraphs(capture=False): the same state bit for bit
    overrides = dict(loss_mode="min", automask_warmup=2, color_jitter=True, hflip=True)
    single, multi_trainer = _small_trainer(**overrides), _small_trainer(**overrides)
    for t in (single, multi_trainer):
        t.state.scheduler = make_lr_schedule(t.state.optimizer, 1, 0.5, steps_per_epoch=2)
    single.train_step.graphs = StepGraphs(CPU, capture=False)
    multi = make_multi_step(multi_trainer.state, 3, device="cpu", graph=False,
                            **{k: getattr(single.train_step, k) for k in STEP_ARGS})
    data = list(SyntheticTripletDataset(6, 2, 32, 64, seed=13, uint8_images=True).batches())
    for start in (0, 3):
        chunk = data[start:start + 3]
        for batch in chunk:
            want = single.train_step(batch)
        got = multi({k: np.stack([b[k] for b in chunk]) for k in chunk[0]})
        assert all(torch.equal(got[k], want[k]) for k in want)
        a, b = _state_tensors(multi_trainer), _state_tensors(single)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        assert not differ, differ[:5]
    assert multi_trainer.state.step == single.state.step == 6
    assert ([g["lr"] for g in multi_trainer.state.optimizer.param_groups]
            == [g["lr"] for g in single.state.optimizer.param_groups])


@pytest.mark.parametrize("modules", [False, True], ids=["no_modules", "modules"])
def test_step_graphs_record_one_copy_in_a_call_after_the_first(modules):
    # StepGraphs(capture=False) under a profiler, 4 calls of one signature:
    # graph.eager on the first, graph.capture (holding its copy_in) on the
    # second, graph.copy_in on each later one; graph.check_weights on every
    # call once a graph exists
    from unsupervised_pseuso_lidar_tpu_torch.utils import profiling

    net = nn.Linear(3, 2)
    graphs = StepGraphs(CPU, capture=False, modules=[net] if modules else ())

    def body(inputs):
        return {"y": net(inputs["x"])}

    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = [graphs(body, {"x": torch.full((4, 3), float(i))}) for i in range(4)]
    assert torch.equal(outs[3]["y"], net(torch.full((4, 3), 3.0)))
    records = profiling.spans()
    names = [s.name for s in records]
    assert names.count("graph.eager") == 1 and names.count("graph.capture") == 1
    copies = [s for s in records if s.name == "graph.copy_in"]
    assert len(copies) == 3
    capture = next(s for s in records if s.name == "graph.capture")
    assert copies[0].parent == capture.id and capture.child_ns > 0
    assert all(s.parent is None for s in copies[1:])
    assert names.count("graph.check_weights") == 2
    assert "graph.replay" not in names and "graph.clone_out" not in names


def test_graph_true_is_refused_on_the_cpu_and_under_a_mesh():
    import torch.distributed as dist

    from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed

    state = _linear_state()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_train_step(state, device="cpu", graph=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_multi_step(state, 2, device="cpu", graph=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        EvalStep(state.depth_model, state.pose_model, device="cpu", graph=True)
    # a one-rank gloo mesh
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device="cpu")
    try:
        mesh = make_mesh(1, device="cpu")
        assert mesh.distributed and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="needs a CUDA device"):
            make_train_step(state, device="cpu", mesh=mesh, graph=True)
        assert not make_train_step(state, device="cpu", mesh=mesh).graphs.graphed
        # a CUDA device under a gloo mesh: its collectives run on the host
        with pytest.raises(ValueError, match="under a gloo mesh"):
            graph_enabled(True, torch.device("cuda", 0), mesh)
    finally:
        dist.destroy_process_group()
    # the default captures on a CUDA device without a mesh, not under gloo
    assert graph_enabled(None, torch.device("cuda", 0)) is True
    assert graph_enabled(None, torch.device("cuda", 0), mesh) is False
    assert graph_enabled(None, CPU) is False
    assert graph_enabled(False, torch.device("cuda", 0)) is False
    assert not make_train_step(state, device="cpu").graphs.graphed


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 2, 2), (2, 1, 3, 2)])
def test_reflect_pad_gradient_is_torch_s_in_a_fixed_order(shape):
    # the decoder's reflection pad (ops/resample.reflect_pad1): torch's
    # forward bit for bit; its gradient folds the padded rows, then
    # columns, in a fixed order (torch's CUDA backward adds with atomics),
    # equal to torch's to rounding and to the fp64 gradient check
    from unsupervised_pseuso_lidar_tpu_torch.ops.resample import reflect_pad1

    gen = torch.Generator().manual_seed(17)
    x = torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn(*shape[:2], shape[2] + 2, shape[3] + 2, generator=gen,
                    dtype=torch.float64)
    got = reflect_pad1(x)
    want = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="reflect")
    assert torch.equal(got, want)
    (dx,) = torch.autograd.grad(got, x, g)
    (ref,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(dx, ref, rtol=1e-15, atol=1e-15)
    assert torch.autograd.gradcheck(reflect_pad1, (x,))


def test_launches_are_counted_once_a_replay():
    # a capture's wrapper calls launch nothing: captured_launches takes
    # them back and records them; add_launches counts them per replay
    kernels.reset_launch_counts()
    kernels.launch_counts["ssim_fwd"] = 5
    with kernels.captured_launches() as made:
        kernels.launch_counts["warp_bilinear_fwd"] += 1
        kernels.launch_counts["ssim_fwd"] += 2
    assert made == {"warp_bilinear_fwd": 1, "warp_bilinear_bwd": 0, "ssim_fwd": 2,
                    "ssim_bwd": 0}
    assert kernels.launch_counts == {"warp_bilinear_fwd": 0, "warp_bilinear_bwd": 0,
                                     "ssim_fwd": 5, "ssim_bwd": 0}
    for _ in range(3):
        kernels.add_launches(made)
    assert kernels.launch_counts == {"warp_bilinear_fwd": 3, "warp_bilinear_bwd": 0,
                                     "ssim_fwd": 11, "ssim_bwd": 0}
    # taken back also when the capture raises
    with pytest.raises(RuntimeError):
        with kernels.captured_launches():
            kernels.launch_counts["ssim_bwd"] += 1
            raise RuntimeError("capture failed")
    assert kernels.launch_counts["ssim_bwd"] == 0
    kernels.reset_launch_counts()


def test_step_graphs_key_by_signature_and_reset():
    # one entry a signature (keys, shapes, dtypes); the first call of each
    # is eager on the caller's tensors, later ones run on the buffers;
    # reset drops them all
    seen = []

    def body(inputs):
        seen.append(inputs["x"])
        return {"y": inputs["x"] * 2}

    graphs = StepGraphs(CPU, capture=False)
    a, b = torch.ones(3), torch.ones(4)
    assert torch.equal(graphs(body, {"x": a})["y"], a * 2)
    assert seen[-1] is a and not graphs.graphs
    out = graphs(body, {"x": a + 1})
    assert torch.equal(out["y"], (a + 1) * 2) and seen[-1] is not a
    static = seen[-1]
    graphs(body, {"x": a + 2})
    assert seen[-1] is static and torch.equal(static, a + 2)
    graphs(body, {"x": b})
    assert seen[-1] is b and len(graphs.graphs) == 1
    graphs(body, {"x": b.double()})
    assert seen[-1].dtype == torch.float64
    graphs.reset()
    graphs(body, {"x": a})
    assert seen[-1] is a and not graphs.graphs


def test_step_graphs_run_the_body_as_it_is_where_nothing_is_captured():
    # on the CPU (graph None) every call runs the body on the caller's
    # tensors: no buffer, no graph, no replay; on_eager is entered around
    # the first call of each signature (its shapes, dtypes and static
    # values) and never again
    entered, seen = [], []

    @contextlib.contextmanager
    def on_eager():
        entered.append(1)
        yield

    def body(inputs, scale):
        seen.append(inputs["x"])
        return {"y": inputs["x"] * scale}

    graphs = StepGraphs(CPU)
    assert not graphs.graphed and graphs.pool is None
    a, b = torch.ones(3), torch.ones(4)
    calls = [(a, 2, 1), (a + 1, 2, 1), (b, 2, 2), (b, 3, 3), (a, 2, 3), (b.double(), 3, 4),
             (b + 1, 3, 4)]
    for x, scale, count in calls:
        out = graphs(body, {"x": x}, (scale,), on_eager=on_eager)
        assert seen[-1] is x and torch.equal(out["y"], x * scale)
        assert len(entered) == count
    assert not graphs.graphs and graphs.replays == 0


@pytest.mark.parametrize("static", [False, True], ids=["eager", "static_buffers"])
def test_the_step_counts_saved_bytes_once_a_signature(monkeypatch, static):
    # the eager train step (graph=False) and the graph protocol on the
    # CPU's static buffers: the first call of a batch shape sets
    # saved_bytes and the counters train.saved_bytes and
    # train.bn_one_pass; a second call of that shape sets nothing; a new
    # shape sets them anew, its own bytes
    trainer = _small_trainer(loss_mode="min")
    step = trainer.train_step
    assert not step.graphs.graphed
    if static:
        step.graphs = StepGraphs(CPU, capture=False)
    norms = sum(isinstance(m, BatchNorm2d) for net in (trainer.state.depth_model,
                                                       trainer.state.pose_model)
                for m in net.modules())
    small = list(SyntheticTripletDataset(3, 2, 32, 64, seed=13, uint8_images=True).batches())
    large = next(SyntheticTripletDataset(1, 2, 64, 64, seed=14, uint8_images=True).batches())
    monkeypatch.setattr(profiling, "COUNTERS", {})
    step(small[0])
    first = step.saved_bytes
    assert first > 0 and norms > 0
    assert profiling.counter(SAVED_BYTES) == first and profiling.counter(BN_ONE_PASS) == norms
    monkeypatch.setattr(profiling, "COUNTERS", {})
    for batch in small[1:]:
        step(batch)
    assert step.saved_bytes == first
    assert profiling.counter(SAVED_BYTES) is None and profiling.counter(BN_ONE_PASS) is None
    step(large)
    assert step.saved_bytes > first
    assert profiling.counter(SAVED_BYTES) == step.saved_bytes
    assert profiling.counter(BN_ONE_PASS) == norms
