"""BtsModel trained by the port's Trainer.train_step, held to the
benchmark's plain reference, and the counter of the bytes a training step
saves for its backward.

BtsModel (DenseNet-161, num_features 128) with PoseFc at 64x128, batch 2:
three eager steps on the CPU from weights drawn from one seed
(portbench/core/weights.fill, the init of the benchmark's BTS training
configuration), against the plain reference
(portbench/reference/nets/BtsModel.py, PoseFc.py, reference/loss.py) in
float32 on the same weights and batches, its loss over all five of
BtsModel's full-resolution outputs. Compared: each step's loss, each
leaf's first gradient and each leaf's change after the three steps (the
norms, each gap over the larger of the reference leaf's norm and the
median leaf's, as the benchmark's train_closed driver compares them). A
reference that scores the final depth alone, one output in place of
five, fails the same tolerances.

The counter (utils/profiling.SavedBytes, TrainStep.saved_bytes, the
counter "train.saved_bytes", read by portbench/metrics/saved_gib.train.py)
is held to hand-summed bytes on a small stack, to the step's bits, and to
the eager call alone.
"""

import contextlib
import copy
import json

import pytest
import torch
from torch import nn

from portbench.core import spec
from portbench.core.outcome import Outcome
from portbench.core.synthetic import batch_seed, triplet_batch
from portbench.core.trace import TraceSlice
from portbench.core.weights import fill
from portbench.drivers.train_closed import kept_leaves, leaf_gap, objective, reference_net
from portbench.reference import loss as ref_loss
from unsupervised_pseuso_lidar_tpu_torch.models.layers import BatchNorm2d
from unsupervised_pseuso_lidar_tpu_torch.train import trainer as trainer_module
from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
from unsupervised_pseuso_lidar_tpu_torch.train.graph import StepGraphs
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import SAVED_BYTES, Trainer
from unsupervised_pseuso_lidar_tpu_torch.utils import profiling
from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import SavedBytes, counter

CPU = torch.device("cpu")
SEED = 2300000017
STEPS = 3
BATCH, HEIGHT, WIDTH = 2, 64, 128
BTS = {"name": "BtsModel", "num_features": 128, "max_depth": 80.0}
RESNET18 = {"name": "DispResNet"}

# Both sides run float32 on the CPU and part only by the order of their
# sums (the port's fused warp and SSIM kernels against F.grid_sample and
# avg_pool2d, its BatchNorm against nn.BatchNorm2d): over nine seeds a loss
# within 7.9e-6, a leaf's first gradient within 3.2e-3 and its change within
# 9.8e-3. The reference that scores the final output alone reads at least
# 2.0e-3, 66 and 0.61 on the same seeds.
LOSS_TOL = 1e-4  # the largest step's |loss - reference| / |reference|
GRAD_TOL = 0.05  # a leaf's first gradient, the benchmark's grad_gap
CHANGE_TOL = 0.05  # a leaf's change after the steps, change_gap


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(depth: dict) -> dict:
    """The benchmark's training configuration with `depth` as the depth
    net, at 64x128 and batch 2; BtsModel's heads at its stds."""
    config = json.loads(json.dumps(spec.load_cell("train.bts704").config))
    config["trainer"]["model"]["depth"] = dict(depth)
    config["trainer"]["datasets"]["augmentation"].update(image_height=HEIGHT, image_width=WIDTH)
    config["trainer"]["action"]["batch_size"] = BATCH
    if depth["name"] != "BtsModel":
        config["init"]["std"] = {k: v for k, v in config["init"]["std"].items()
                                 if k.startswith("pose.")}
    return config


def _batches():
    return [triplet_batch(BATCH, HEIGHT, WIDTH, batch_seed(SEED, i), CPU) for i in range(STEPS)]


def _trainer(config: dict, tmp) -> Trainer:
    trainer_config = copy.deepcopy(config["trainer"])
    trainer_config["action"]["checkpoint_dir"] = str(tmp)
    trainer = Trainer(Config.from_dict(trainer_config), device=CPU)
    fill({"depth": trainer.state.depth_model, "pose": trainer.state.pose_model}, SEED,
         config["init"])
    return trainer


def _named(depth: nn.Module, pose: nn.Module):
    return ([(f"depth.{n}", p) for n, p in depth.named_parameters()]
            + [(f"pose.{n}", p) for n, p in pose.named_parameters()])


def _norms(tensors):
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def _snapshot(trainer: Trainer, loss) -> dict:
    """The step's loss, each leaf's gradient and Adam's state, copied."""
    named = _named(trainer.state.depth_model, trainer.state.pose_model)
    state = trainer.state.optimizer.state
    return {"loss": loss.detach().clone(),
            "grad": {n: p.grad.detach().clone() for n, p in named if p.grad is not None},
            "adam": {n: {k: v.detach().clone() for k, v in state[p].items()}
                     for n, p in named if p in state}}


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """The port's three steps: losses, first gradients, changes; the first
    step's snapshot and saved bytes."""
    config = _config(BTS)
    trainer = _trainer(config, tmp_path_factory.mktemp("bts"))
    named = _named(trainer.state.depth_model, trainer.state.pose_model)
    start = {n: p.detach().clone() for n, p in named}
    losses, saved = [], []
    for i, batch in enumerate(_batches()):
        loss = trainer.train_step(batch)["loss"]
        losses.append(float(loss))
        saved.append(trainer.train_step.saved_bytes)
        if i == 0:
            first = _snapshot(trainer, loss)
    return {"config": config, "losses": losses, "first": first, "saved": saved,
            "grad": _norms(first["grad"]),
            "change": _norms({n: p.detach() - start[n] for n, p in named})}


def _final_output_alone(depth: nn.Module) -> None:
    """Make the reference BtsModel return its final depth alone."""
    forward = type(depth).forward
    depth.forward = lambda x: forward(depth, x)[-1:]
    depth.scales = (0,)


@pytest.mark.parametrize("outputs", ["all five", "the final one"])
def test_bts_train_steps_against_the_reference(program, outputs):
    config = program["config"]
    depth = reference_net(config["trainer"], "depth")
    pose = reference_net(config["trainer"], "pose")
    fill({"depth": depth, "pose": pose}, SEED, config["init"])
    if outputs == "the final one":
        _final_output_alone(depth)
    lr = config["trainer"]["action"]["optimizer"]["depth"]["lr"]
    losses, grads, change = ref_loss.train_steps(depth, pose, _batches(),
                                                 objective(config["trainer"]), lr)
    reference_grad = _norms(grads)
    keep = kept_leaves(reference_grad)
    assert len(keep) == len(reference_grad) == len(program["grad"])
    gaps = {"loss": max(abs(p - r) / abs(r) for p, r in zip(program["losses"], losses)),
            "grad": leaf_gap(program["grad"], reference_grad, keep),
            "change": leaf_gap(program["change"], change, keep)}
    tolerances = {"loss": LOSS_TOL, "grad": GRAD_TOL, "change": CHANGE_TOL}
    within = {k: gaps[k] <= tolerances[k] for k in gaps}
    if outputs == "all five":
        assert all(within.values()), gaps
    else:
        assert not any(within.values()), gaps


def test_saved_bytes_are_the_hand_summed_activations():
    # conv -> BatchNorm -> ReLU -> conv on [2, 3, 16, 20]: the first conv
    # keeps its input, the BatchNorm its input and its batch mean and
    # inverse deviation (8 floats each), the ReLU its output, which the
    # second conv keeps too (one storage); the weights are left out
    torch.manual_seed(0)
    stack = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), BatchNorm2d(8), nn.ReLU(),
                          nn.Conv2d(8, 4, 3, padding=1))
    x = torch.randn(2, 3, 16, 20)
    with SavedBytes(exclude=list(stack.parameters())) as saved:
        stack(x).sum().backward()
    activation = 2 * 8 * 16 * 20 * 4
    assert saved.bytes == x.nbytes + activation + 2 * 8 * 4 + activation
    with SavedBytes() as with_weights:
        stack(x)
    weights = sum(p.nbytes for p in stack.parameters() if p.ndim > 1)
    assert with_weights.bytes == saved.bytes + weights + 8 * 4  # + the BatchNorm scale


def test_the_counter_changes_no_bit_of_a_step(program, tmp_path):
    trainer = _trainer(program["config"], tmp_path)
    trainer.train_step.counting_saved = contextlib.nullcontext
    loss = trainer.train_step(_batches()[0])["loss"]
    assert trainer.train_step.saved_bytes is None
    counted, plain = program["first"], _snapshot(trainer, loss)
    assert torch.equal(counted["loss"], plain["loss"])
    assert counted["grad"].keys() == plain["grad"].keys()
    assert all(torch.equal(counted["grad"][n], plain["grad"][n]) for n in plain["grad"])
    assert counted["adam"].keys() == plain["adam"].keys() and plain["adam"]
    for name, state in plain["adam"].items():
        assert all(torch.equal(counted["adam"][name][k], v) for k, v in state.items())


@pytest.mark.parametrize("graphs", [False, True])
def test_the_counter_is_set_on_the_eager_call_alone(tmp_path, monkeypatch, graphs):
    counts = []

    class Counted(SavedBytes):
        def __exit__(self, *exc):
            super().__exit__(*exc)
            counts.append(self.bytes)

    monkeypatch.setattr(trainer_module, "SavedBytes", Counted)
    monkeypatch.setattr(profiling, "COUNTERS", {})
    trainer = _trainer(_config(RESNET18), tmp_path)
    step = trainer.train_step
    if graphs:
        # the CUDA graph protocol on the CPU: eager, capture, replays
        step.graphs = StepGraphs(CPU, capture=False)
    batches = _batches()
    step(batches[0])
    assert len(counts) == 1 and counts[0] > 0
    assert step.saved_bytes == counter(SAVED_BYTES) == counts[0]
    for batch in batches[1:] + batches[:1]:
        step(batch)
    assert len(counts) == 1
    assert step.saved_bytes == counter(SAVED_BYTES) == counts[0]
    if graphs:
        assert len(step.graphs.graphs) == 1


def test_bts_saves_more_than_resnet18_at_the_same_size(program, tmp_path):
    trainer = _trainer(_config(RESNET18), tmp_path)
    trainer.train_step(_batches()[0])
    resnet18 = trainer.train_step.saved_bytes
    assert program["saved"] == [program["saved"][0]] * STEPS
    assert program["saved"][0] > 2 * resnet18 > 0


def test_the_saved_gib_reader(monkeypatch):
    reader = spec.metric_reader("saved_gib.train")
    traced = Outcome({}, 4, 0, 0, slice=TraceSlice(4, 1000.0, 900.0, [], {}, {}))
    monkeypatch.setattr(profiling, "COUNTERS", {})
    assert reader.read(Outcome({}, 0, 0, 0)) is None
    assert reader.read(traced) is None
    profiling.set_counter(SAVED_BYTES, 3 * 2 ** 29)
    assert reader.read(Outcome({}, 0, 0, 0)) is None
    assert reader.read(traced) == 1.5
    # a program without the counter, as the commits before it
    monkeypatch.delattr(profiling, "counter")
    assert reader.read(traced) is None
