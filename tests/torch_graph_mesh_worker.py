"""Ranks of tests/test_torch_graph_mesh.py: the mesh step's body run the
way a CUDA graph replays it (StepGraphs(capture=False): the first call
eager, the later ones on static buffers refilled at each call) against the
eager mesh step, on gloo ranks on the CPU.

Kept out of pytest's collection by its name; spawned through
torch_parallel_worker.run_ranks. Each rank compares its own two runs and
returns only the keys that differ, not the tensors.
"""

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.train.graph import StepGraphs
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    TrainState,
    make_eval_step,
    make_lr_schedule,
    make_multi_step,
    make_optimizer,
    make_train_step,
)

try:  # spawned ranks import this file by its module name
    import torch_parallel_worker as worker
except ImportError:
    from tests import torch_parallel_worker as worker

CPU = torch.device("cpu")
STEPS, MULTI = 2, 2


def _state(seed=0):
    """DispResNet-18 + PoseNet from a seeded generator (every rank the
    same), configs/tpu_v5e.yaml's Adam and a StepLR."""
    gen = torch.Generator().manual_seed(seed)
    depth = build_model("DispResNet", gen, device="cpu")
    pose = build_model("PoseNet", gen, device="cpu")
    with torch.no_grad():  # a pose head that moves the warp off the identity
        pose.pose_pred.bias.copy_(torch.randn(pose.pose_pred.bias.shape, generator=gen))
    cfg = worker.config_module.load_config(f"{worker.REPO}/configs/tpu_v5e.yaml")
    optimizer = make_optimizer(cfg, depth, pose)
    return TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))


def _batches(count, seed):
    return list(SyntheticTripletDataset(count, worker.BATCH, worker.HEIGHT, worker.WIDTH,
                                        seed=seed, uint8_images=True).batches())


def _tensors(state):
    out = {}
    for net, model in (("depth", state.depth_model), ("pose", state.pose_model)):
        out.update({f"{net}.{k}": v for k, v in model.state_dict().items()})
        out.update({f"{net}.{k}.grad": p.grad for k, p in model.named_parameters()
                    if p.grad is not None})
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in slots.items()})
    return out


def _differ(got, want, where):
    out = [f"{where}: keys {sorted(got)} != {sorted(want)}"] if sorted(got) != sorted(want) else []
    return out + [f"{where}: {k}" for k in want if not torch.equal(got[k], want[k])]


def static_vs_eager(mesh):
    """TrainStep ('min', 'ssim' with supervised) for STEPS steps,
    make_multi_step(MULTI) twice and EvalStep over 2 batches under `mesh`:
    eager against the body on static buffers, from one seeded state each.
    -> {"differ": [keys that are not equal bit for bit], "default_graphs":
    whether graph=None made graphs under this gloo mesh, "signatures":
    the static runs' graph counts}."""
    differ, signatures, default = [], {}, []
    cases = {"min": dict(loss_mode="min"),
             "ssim_supervised": dict(loss_mode="ssim", supervised_weight=0.1)}
    for name, kwargs in cases.items():
        runs = []
        for static in (False, True):
            state = _state()
            step = make_train_step(state, device="cpu", mesh=mesh, **worker.STEP_SETTINGS,
                                   **kwargs)
            default.append(step.graphs.graphed)
            if static:
                step.graphs = StepGraphs(CPU, capture=False)
            metrics = [step(b) for b in _batches(STEPS, seed=31)]
            runs.append((metrics, _tensors(state)))
            if static:
                signatures[name] = len(step.graphs.graphs)
        (m_eager, t_eager), (m_static, t_static) = runs
        for i, (got, want) in enumerate(zip(m_static, m_eager)):
            differ += _differ(got, want, f"{name} step {i} metrics")
        differ += _differ(t_static, t_eager, f"{name} state")

    runs = []
    for static in (False, True):
        state = _state()
        multi = make_multi_step(state, MULTI, mesh=mesh, device="cpu", loss_mode="min",
                                **worker.STEP_SETTINGS)
        default.append(multi.train_step.graphs.graphed)
        if static:
            multi.train_step.graphs = StepGraphs(CPU, capture=False)
        batches = _batches(2 * MULTI, seed=32)
        metrics = [multi({k: np.stack([b[k] for b in chunk]) for k in chunk[0]})
                   for chunk in (batches[:MULTI], batches[MULTI:])]
        runs.append((metrics, _tensors(state)))
    (m_eager, t_eager), (m_static, t_static) = runs
    for i, (got, want) in enumerate(zip(m_static, m_eager)):
        differ += _differ(got, want, f"multi call {i} metrics")
    differ += _differ(t_static, t_eager, "multi state")

    state = _state()
    steps = []
    for static in (False, True):
        step = make_eval_step(state.depth_model, state.pose_model, loss_mode="min",
                              eval_protocol="eigen", pose_metrics=True, mesh=mesh, device="cpu")
        default.append(step.graphs.graphed)
        if static:
            step.graphs = StepGraphs(CPU, capture=False)
        steps.append(step)
    for i, batch in enumerate(_batches(2, seed=33)):
        (want, want_depth), (got, got_depth) = steps[0](batch), steps[1](batch)
        differ += _differ(got, want, f"eval batch {i} metrics")
        if not torch.equal(got_depth, want_depth):
            differ.append(f"eval batch {i}: depth_pred")
    signatures["eval"] = len(steps[1].graphs.graphs)
    return {"differ": differ, "default_graphs": any(default), "signatures": signatures}
