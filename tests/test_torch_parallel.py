"""Port parity for data parallelism (parallel/, the step under a mesh).

Under JAX's ("data",) mesh the step is the single-device program on the
GLOBAL batch. The port runs one process a rank, each on its rows, and
must give the same result: the placement of rows on ranks, the three
reductions over the batch that the ranks make global (BatchNorm
statistics, the 'ssim' clip threshold, the supervised masked mean), the
whole step against the JAX step on the full batch and against the port's
own one-process step, the multi-step, and the training CLI's --mesh.

The ranks are gloo process groups of 2 spawned on the CPU
(tests/torch_parallel_worker.py, one thread each); one group computes
every step case, whose tests then read its results.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_parallel_worker as worker
from tests.test_torch_train import _jax_step, jax_models  # noqa: F401
from unsupervised_pseuso_lidar_tpu.parallel import mesh as jax_mesh
from unsupervised_pseuso_lidar_tpu_torch.cli import train as train_cli
from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import photometric_loss
from unsupervised_pseuso_lidar_tpu_torch.parallel import distributed
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    make_train_step,
    supervised_loss,
)
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
RANKS = 2
# the reductions over ranks vs one process on the concatenated input
REDUCTION_RTOL = 1e-6
# the 2-rank step vs the port's one-process step: the gradient (every
# parameter's, concatenated) at rel L2, the metrics, BatchNorm statistics
STEP_GRAD_REL_L2 = 1e-4
STEP_METRIC_RTOL = 1e-5
STATS_RTOL = 1e-5
# the 2-rank step's loss vs the JAX step on the full batch: JAX's own
# sharded-vs-single-device tolerance (tests/test_train.py)
JAX_LOSS_RTOL = 2e-4


def _rel_l2(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [2, 4])
def test_shard_batch_takes_the_rows_jax_places_on_each_device(ranks):
    # accum_steps 1: rank r holds the rows JAX's batch_sharding puts on
    # device r, ground truth [B, H, W] alike; accum_steps 2: its rows of
    # EVERY micro-batch, as JAX places the reshaped [2, B/2, ...] batch
    rng = np.random.default_rng(0)
    batch = {"tgt": rng.uniform(size=(8, 4, 6, 3)).astype(np.float32),
             "groundtruth": rng.uniform(size=(8, 4, 6)).astype(np.float32)}
    mesh = jax_mesh.make_mesh(ranks)
    placed = jax_mesh.shard_batch(mesh, batch)
    micro = jax.device_put(batch["tgt"].reshape(2, 4, 4, 6, 3),
                           NamedSharding(mesh, P(None, "data")))
    for rank, device in enumerate(mesh.devices.reshape(-1)):
        ours = Mesh(None, rank, ranks, torch.device("cpu"))
        got = shard_batch(ours, batch)
        for key in batch:
            shard = next(s for s in placed[key].addressable_shards if s.device == device)
            np.testing.assert_array_equal(got[key], np.asarray(shard.data), err_msg=key)
        shard = next(s for s in micro.addressable_shards if s.device == device)
        got = shard_batch(ours, {"tgt": torch.from_numpy(batch["tgt"])}, accum_steps=2)
        np.testing.assert_array_equal(got["tgt"].numpy(),
                                      np.asarray(shard.data).reshape(-1, 4, 6, 3))
        assert shard_batch(ours, got, accum_steps=2) is got  # placed once
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh(None, 0, ranks, torch.device("cpu")), batch, accum_steps=3)


def test_mesh_and_initialize_without_a_group(monkeypatch):
    # no torchrun variables: initialize() does nothing; only the
    # one-device mesh exists, with no group (no collective runs); a
    # spatial axis, like a data axis of 2, needs a process group
    for var in (*distributed.ENV_VARS, "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.distributed) == ({"data": 1}, 0, False)
    assert distributed.global_mesh(device="cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match="process group of 2"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="spatial=2.*process group of 2"):
        make_mesh(spatial=2, device="cpu")


# --------------------------------------------------------------------------
# the three reductions over the batch
# --------------------------------------------------------------------------


def _reduction_inputs():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 5, 6, 7, generator=gen)
    x[:2] += 1.5  # the ranks' rows differ in mean and spread
    x[2:] *= 0.5
    g = torch.randn(4, 5, 6, 7, generator=gen)
    pred = torch.rand(4, 3, 9, 11, generator=gen)
    target = torch.rand(4, 3, 9, 11, generator=gen)
    target[2:] = 0.5 * target[2:] + 0.25
    disp = torch.rand(4, 1, 6, 7, generator=gen) * 0.8 + 0.05
    gt = torch.rand(4, 6, 7, generator=gen) * 50.0 + 1.0
    gt[2:, :4] = 0.0  # rank 1 holds fewer LiDAR returns
    return x, g, pred, target, disp, gt


@pytest.fixture(scope="module")
def reductions(tmp_path_factory):
    inputs = _reduction_inputs()
    ranks = worker.run_ranks(worker.reductions, RANKS, tmp_path_factory.mktemp("red"),
                             *inputs)
    return inputs, ranks


def _one_process_reductions(x, g, pred, target, disp, gt):
    bn = worker.batch_norm_module(x.shape[1])
    leaf = x.clone().requires_grad_()
    out = bn(leaf)
    (out * g).sum().backward()
    disp_leaf = disp.clone().requires_grad_()
    sup = supervised_loss(disp_leaf, gt)
    sup.backward()
    return {"bn": {"out": out.detach(), "x_grad": leaf.grad, "weight_grad": bn.weight.grad,
                   "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
                   "running_var": bn.running_var},
            "clip": {"map": photometric_loss(pred, target)},
            "supervised": {"value": sup.detach(), "disp_grad": disp_leaf.grad}}


def _per_rank(x, g, pred, target, disp, gt):
    """What a rank would compute alone on its rows (no collective)."""
    halves = [_one_process_reductions(*(t[r * 2:(r + 1) * 2] for t in (x, g, pred, target,
                                                                    disp, gt)))
              for r in range(RANKS)]
    return {"bn": torch.cat([h["bn"]["out"] for h in halves]),
            "clip": torch.cat([h["clip"]["map"] for h in halves]),
            "supervised": torch.stack([h["supervised"]["value"] for h in halves]).mean()}


@pytest.mark.parametrize("name", ["bn", "clip", "supervised"])
def test_batch_reductions_are_global(reductions, name):
    # 2 ranks vs one process on the concatenated input, each quantity at
    # rel <= 1e-6: BatchNorm's output, running statistics (flax's rule)
    # and input/weight/bias gradients (weight and bias summed over the
    # ranks: each holds its rows' part); the clamped 'ssim' map; the
    # supervised value and its disparity gradient (every rank's loss
    # holds the global value, so a rank's rows get RANKS times theirs,
    # which the step's gradient average divides out). The per-rank
    # reduction is far off, so these tests see the difference.
    inputs, ranks = reductions
    ref = _one_process_reductions(*inputs)[name]
    got = {}
    for key in ref:
        parts = [r[name][key] for r in ranks]
        if key in ("running_mean", "running_var", "value"):
            assert torch.equal(parts[0], parts[1]), key  # the same on every rank
            got[key] = parts[0]
        elif key in ("weight_grad", "bias_grad"):
            got[key] = parts[0] + parts[1]
        elif key == "disp_grad":
            got[key] = torch.cat(parts) / RANKS
        else:
            got[key] = torch.cat(parts)
        rel = _rel_l2(got[key], ref[key])
        assert rel <= REDUCTION_RTOL, (key, rel)
    per_rank = _per_rank(*inputs)[name]
    first = "out" if name == "bn" else "map" if name == "clip" else "value"
    assert _rel_l2(per_rank, ref[first]) > 100 * REDUCTION_RTOL
    if name == "bn":
        # no group: the path is F.batch_norm's, bit for bit
        x = inputs[0]
        plain, meshed = worker.batch_norm_module(5), worker.batch_norm_module(5)
        meshed.mesh = make_mesh(device="cpu")
        assert torch.equal(plain(x), meshed(x))
        assert torch.equal(F.batch_norm(x, None, None, plain.weight, plain.bias, True, 0.0,
                                        1e-5), meshed(x))


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights(jax_models):  # noqa: F811
    _, _, params, stats = jax_models
    return {"depth": state_dict_from_jax(params["depth"], stats, "DispResNet"),
            "pose": state_dict_from_jax(params["pose"], {}, "PoseNet")}


@pytest.fixture(scope="module")
def rank_steps(jax_models, weights, tmp_path_factory):  # noqa: F811
    """(every rank's worker.train_steps, the JAX step's loss on the 'min'
    case's whole batch, computed while the ranks run)."""
    wait = worker.start_ranks(worker.train_steps, RANKS, tmp_path_factory.mktemp("steps"),
                              weights)
    # make_train_step_body on the whole batch on one device
    _, ref = _jax_step(jax_models, worker.step_batch("min"), accum_steps=1)
    return wait(), float(ref["loss"])


def _one_process_step(weights, name):
    _, kwargs = worker.STEP_CASES[name]
    state = worker.make_state(weights)
    step = make_train_step(state, device="cpu", **worker.STEP_SETTINGS, **kwargs)
    return worker.step_result(state, step(worker.step_batch(name)))


def _flat(grads):
    return torch.cat([g.reshape(-1) for _, g in sorted(grads.items()) if g is not None])


def test_step_matches_the_jax_step_on_the_global_batch(rank_steps):
    # 'min' at 64x96, batch 4 split 2 + 2: the ranks' all-reduced loss vs
    # make_train_step_body on the whole batch on one device
    ranks, ref_loss = rank_steps
    for rank in ranks:
        np.testing.assert_allclose(rank["min"]["metrics"]["loss"], ref_loss,
                                   rtol=JAX_LOSS_RTOL)


@pytest.mark.parametrize("name", sorted(worker.STEP_CASES))
def test_step_matches_the_one_process_step(weights, rank_steps, name):
    # every rank returns the same metrics and gradients; against the
    # port's step on the whole batch in one process: the gradient at rel
    # L2 <= 1e-4 (worst key printed), the metrics and the BatchNorm
    # running statistics. The mean of the per-rank steps (each rank's
    # rows alone: what a rank computes without the collectives) is far
    # off, so the test sees a per-rank reduction.
    ranks = [r[name] for r in rank_steps[0]]
    for key in ranks[0]["grads"]:
        a, b = ranks[0]["grads"][key], ranks[1]["grads"][key]
        assert (a is None and b is None) or torch.equal(a, b), key
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    got = ranks[0]
    ref = _one_process_step(weights, name)
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for key, value in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=STEP_METRIC_RTOL,
                                   err_msg=key)
    assert [k for k, g in got["grads"].items() if g is None] == \
        [k for k, g in ref["grads"].items() if g is None]
    rel = _rel_l2(_flat(got["grads"]), _flat(ref["grads"]))
    worst = max((_rel_l2(g, ref["grads"][k]), k) for k, g in got["grads"].items()
                if g is not None and float(ref["grads"][k].abs().max()) > 0)
    print(f"{name}: gradient rel L2 {rel:.3g}; worst key {worst[1]} at {worst[0]:.3g}")
    assert rel <= STEP_GRAD_REL_L2, rel
    for key, value in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][key].numpy(), value.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_RTOL, err_msg=key)
    per_rank = (_flat(ranks[0]["alone"]["grads"]) + _flat(ranks[1]["alone"]["grads"])) / 2
    assert _rel_l2(per_rank, _flat(ref["grads"])) > 10 * STEP_GRAD_REL_L2


def test_eval_step_metrics_are_the_global_batch_s(weights, rank_steps):
    # EvalStep under the mesh ('ssim' loss, Eigen protocol, pose metrics)
    # vs one process on the whole batch: every metric at rel 1e-5 and the
    # same on both ranks. Rank 1 holds one image with ground truth and
    # rank 0 two, so the depth metrics are a mean over the 3 images, not
    # the mean of the ranks' means (which the test sees to differ)
    ranks = [r["eval"] for r in rank_steps[0]]
    assert ranks[0]["mesh"] == ranks[1]["mesh"]
    ref = worker.eval_metrics(weights)
    assert sorted(ranks[0]["mesh"]) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(ranks[0]["mesh"][key], value, rtol=STEP_METRIC_RTOL,
                                   err_msg=key)
    per_rank = (ranks[0]["alone"]["abs_rel"] + ranks[1]["alone"]["abs_rel"]) / 2
    assert abs(per_rank - ref["abs_rel"]) > 1e-3 * abs(ref["abs_rel"])


@pytest.mark.parametrize("under_mesh", [False, True])
def test_multi_step_equals_sequential_steps(weights, rank_steps, under_mesh):
    # make_multi_step(num_steps=2) over [2, B, ...] batches vs two
    # TrainStep calls: the parameters and the last metrics bit for bit,
    # in one process and on every rank of the 2-rank mesh
    runs = ([r["multi"] for r in rank_steps[0]] if under_mesh
            else [worker.multi_vs_sequential(weights)])
    for (seq_params, seq_metrics), (multi_params, multi_metrics) in runs:
        assert seq_metrics == multi_metrics
        assert sorted(seq_params) == sorted(multi_params)
        for key, value in seq_params.items():
            assert torch.equal(value, multi_params[key]), key
    if under_mesh:
        assert all(torch.equal(runs[0][1][0][k], runs[1][1][0][k]) for k in runs[0][1][0])


# --------------------------------------------------------------------------
# the training CLI and the epoch loop
# --------------------------------------------------------------------------


def _small_config(tmp_path, **action):
    with open(os.path.join("configs", "test_config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["datasets"]["augmentation"].update(image_height=32, image_width=64)
    raw["action"].update(batch_size=2, log_freq=1,
                         checkpoint_dir=str(tmp_path / "checkpoints"), **action)
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_trains_on_two_ranks_checkpoints_once_and_resumes(tmp_path, capfd):
    # --mesh 2 --device cpu: this process is rank 0 and spawns rank 1
    # (gloo). Rank 0 alone writes the checkpoint and the JSON log lines;
    # a run with from_scratch: False restores on both ranks (a rank that
    # did not would fail the state's replication) and trains epoch 1
    def run(epochs, **action):
        return train_cli.main(["--config", _small_config(tmp_path, **action), "--synthetic",
                               "--epochs", str(epochs), "--synthetic-batches", "2",
                               "--device", "cpu", "--mesh", str(RANKS)])

    def logged_steps():
        return [json.loads(line)["step"] for line in capfd.readouterr().out.splitlines()
                if line.startswith("{")]

    trainer = run(1)
    assert trainer.mesh.shape == {"data": RANKS} and trainer.is_main
    assert not torch.distributed.is_initialized()  # the group was left
    assert os.listdir(trainer.checkpoints.directory) == ["epoch_00000.pth"]
    assert trainer.epoch == 0 and trainer.state.step == 2
    assert logged_steps() == [1, 2]
    resumed = run(2, from_scratch=False)
    assert resumed.epoch == 1 and resumed.state.step == 4
    assert sorted(os.listdir(trainer.checkpoints.directory)) == ["epoch_00000.pth",
                                                                 "epoch_00001.pth"]
    assert logged_steps() == [3, 4]


def test_an_interrupt_on_one_rank_stops_every_rank(tmp_path):
    # SIGTERM to rank 1 alone during epoch 0 of 3: both ranks finish the
    # epoch, rank 0 checkpoints it, and both stop
    config = config_module.load_config(_small_config(tmp_path, num_epochs=3))
    ranks = worker.run_ranks(worker.interrupted_fit, RANKS, tmp_path, config)
    assert [r["epochs"] for r in ranks] == [[0], [0]]
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["checkpoints"] == ["epoch_00000.pth"]
