"""A closed training loop: the program's captured Trainer.train_step.

Set-up builds one Trainer from the configuration's `trainer` settings (the
program's Config, as cli.train reads a YAML), fills its depth and pose nets
from the seed (core/weights.py, one draw on the card), and stages
`batches` distinct synthetic triplet batches on the card
(core/synthetic.py). The first `checked_steps` steps run through the
window's own call, `trainer.train_step(batch)`, on batches 0, 1, 2: the
first runs eagerly, the second captures the CUDA graph, the third
replays it. They are the steps the reference follows. The window then
calls the same object on the following batches, in turn, until `seconds`
have passed; the card is synchronized before the first and after the
last step. A traced run then profiles `trace_units` more steps.

After the window the program is freed and the plain reference
(reference/loss.py, and reference/nets/<name>.py for the depth and pose
nets the trainer settings name, built from the same keyword arguments)
takes the same weights (filled
from the same seed) and the same batches through the checked steps in full
float32. Compared, each against its limit (limits/<cell>.json):

- grad_gap: over the leaves, the largest gap between the norm of the
  program's first gradient, worked out from Adam's first moment after
  step 1 (m = (1 - beta1) g), and the reference's, over the larger of
  the reference leaf's norm and the median leaf's;
- change_gap: the same for the norm of each leaf's change after the
  checked steps;
- grad_tf32_gap: how far the program's whole first gradient lies from
  the reference's computed in the precision the configuration states
  (cuDNN's TF32 on), ||g - g_tf32|| / ||g_tf32 - g_ref||: in units of how
  far TF32 alone moves the reference's float32 gradient g_ref (floored at
  TF32_FLOOR of ||g_ref||). The loss's gradient jumps at pixel crossings
  and minima, so a precision's error in it adds up from flips of random
  sign; measured against g_ref alone, the bf16 path reads only ~3x TF32's
  on some seeds, against g_tf32 it reads more than 3 and the program far
  less than 1 (PERF.md).

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both (they move under Adam by round-off alone).
Also worked out, and compared only where limits/<cell>.json gives it a
limit: loss_gap, the largest relative gap of a checked step's loss (steps
2 and 3 part by Adam's first, sign-like update, PERF.md).
"""

from __future__ import annotations

import copy
import math
import statistics
import tempfile
import time
from typing import Dict, List

import torch

from portbench.core import device as dev
from portbench.core import spec
from portbench.core.flops import forward_macs
from portbench.core.outcome import Outcome, checks_from
from portbench.core.stats import rate
from portbench.core.synthetic import batch_seed, triplet_batch
from portbench.core.trace import profile
from portbench.core.weights import fill
from portbench.reference import loss as ref_loss

# near-zero leaves: a reference gradient under this share of the median
# leaf's is round-off (a bias before a BatchNorm)
ROUND_OFF_LEAF = 1e-3
# grad_tf32_gap's least denominator, relative to the gradient's norm: where the
# device has no TF32 (the CPU) the TF32 reference equals the exact one; on
# the card TF32 moves the first gradient by 1.1e-3 - 6e-3 of its norm
TF32_FLOOR = 1e-3


def _named(trainer) -> List:
    state = trainer.state
    return ([(f"depth.{n}", p) for n, p in state.depth_model.named_parameters()]
            + [(f"pose.{n}", p) for n, p in state.pose_model.named_parameters()])


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def flat(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The leaves with a gradient, in sorted name order, as one float64
    vector on the host."""
    leaves = [grads[n].detach().double().cpu().flatten() for n in sorted(grads)
              if grads[n].ndim]
    return torch.cat(leaves) if leaves else torch.zeros(0, dtype=torch.float64)


def leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep) -> float:
    """max over the kept leaves of |program - reference| / max(reference,
    median reference leaf)."""
    median = statistics.median(reference[n] for n in keep)
    return max(abs(program[n] - reference[n]) / max(reference[n], median) for n in keep)


def kept_leaves(reference_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(reference_grad.values())
    return [n for n, v in reference_grad.items() if v >= ROUND_OFF_LEAF * median]


def compare(program: Dict, reference: Dict) -> Dict[str, float]:
    """The compared numbers from the program's and the reference's
    {losses, grad, grad_vector, change} and the TF32 reference's first
    gradient (module docstring)."""
    keep = kept_leaves(reference["grad"])
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    ours, exact, tf32 = program["grad_vector"], reference["grad_vector"], reference["tf32_vector"]
    if ours.shape != exact.shape:
        excess = math.inf
    else:
        floor = TF32_FLOOR * torch.linalg.vector_norm(exact)
        excess = float(torch.linalg.vector_norm(ours - tf32)
                       / torch.clamp(torch.linalg.vector_norm(tf32 - exact), min=floor))
    return {"loss_gap": max(losses) if all(map(math.isfinite, program["losses"])) else math.inf,
            "grad_gap": leaf_gap(program["grad"], reference["grad"], keep),
            "change_gap": leaf_gap(program["change"], reference["change"], keep),
            "grad_tf32_gap": excess if math.isfinite(excess) else math.inf}


def objective(trainer_config: dict) -> dict:
    act = trainer_config["action"]
    return {"loss_mode": act["loss_mode"], "smooth_on": act["smooth_on"],
            "smooth_weight": act["smooth_weight"], "depth_norm": act["depth_norm"]}


def reference_net(trainer_config: dict, role: str) -> torch.nn.Module:
    """The plain reference of the trainer's `role` net ("depth" or
    "pose"), from the name and keyword arguments its settings give the
    program's model, built on the current default device."""
    settings = dict(trainer_config["model"][role])
    name = settings.pop("name")
    settings.pop("pretrained_path", None)
    aug = trainer_config["datasets"]["augmentation"]
    return spec.reference_net(name).build(settings, (aug["image_height"], aug["image_width"]))


def _reference_nets(config: dict, seed: int, device: torch.device):
    with torch.device(device):
        depth = reference_net(config["trainer"], "depth")
        pose = reference_net(config["trainer"], "pose")
    fill({"depth": depth, "pose": pose}, seed, config["init"])
    return depth, pose


def reference_run(config: dict, seed: int, batches, device: torch.device) -> Dict:
    """The plain reference through the checked steps in full float32:
    {losses, grad, grad_vector, change}; and `tf32_vector`, its first
    gradient with cuDNN's TF32 as the configuration states it, which
    measures how far TF32 alone puts the first gradient."""
    trainer_config = config["trainer"]
    dev.apply_flags(config["flags"])
    depth, pose = _reference_nets(config, seed, device)
    ref_loss.step_loss(depth, pose, batches[0], objective(trainer_config)).backward()
    tf32 = flat(_grads(depth, pose))
    del depth, pose
    dev.reference_flags()
    depth, pose = _reference_nets(config, seed, device)
    lr = trainer_config["action"]["optimizer"]["depth"]["lr"]
    losses, grads, change = ref_loss.train_steps(depth, pose, batches,
                                                 objective(trainer_config), lr)
    return {"losses": losses, "grad": _norms(grads), "grad_vector": flat(grads),
            "change": change, "tf32_vector": tf32}


def _grads(depth, pose) -> Dict[str, torch.Tensor]:
    named = [(f"depth.{n}", p) for n, p in depth.named_parameters()]
    named += [(f"pose.{n}", p) for n, p in pose.named_parameters()]
    return {n: p.grad.cpu() if p.grad is not None else torch.zeros(()) for n, p in named}


def model_flops_per_step(trainer_config: dict) -> float:
    """Model FLOPs of a training step: 3x the forward (the backward twice
    the forward, no recomputation) of the depth net on 2B images and the
    pose net on B triplets."""
    aug = trainer_config["datasets"]["augmentation"]
    b, h, w = trainer_config["action"]["batch_size"], aug["image_height"], aug["image_width"]
    depth = forward_macs(lambda: reference_net(trainer_config, "depth"), (2 * b, 3, h, w))
    pose = forward_macs(lambda: reference_net(trainer_config, "pose"), (b, 3, h, w),
                        [(b, 3, h, w)] * 2)
    return 3 * 2 * (depth + pose)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False) -> Outcome:
    """One run of the cell (module docstring). control=True runs the
    program's bf16 path, the precision below the configuration's."""
    from unsupervised_pseuso_lidar_tpu_torch.train.config import Config
    from unsupervised_pseuso_lidar_tpu_torch.train.trainer import Trainer

    config, traffic = cell.config, cell.traffic
    dev.apply_flags(config["flags"])
    trainer_config = copy.deepcopy(config["trainer"])
    act = trainer_config["action"]
    aug = trainer_config["datasets"]["augmentation"]
    b, h, w = act["batch_size"], aug["image_height"], aug["image_width"]
    checked = traffic["checked_steps"]
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        act["checkpoint_dir"] = tmp
        act["precision"] = "bf16" if control else act.get("precision", "fp32")
        trainer = Trainer(Config.from_dict(trainer_config), device=device)
        fill({"depth": trainer.state.depth_model, "pose": trainer.state.pose_model}, seed,
             config["init"])
        batches = [triplet_batch(b, h, w, batch_seed(seed, i), device)
                   for i in range(traffic["batches"])]
        named = _named(trainer)
        start = {n: p.detach().clone() for n, p in named}
        beta1 = trainer.state.optimizer.param_groups[0]["betas"][0]
        losses, first_grad = [], {}
        for i in range(checked):
            losses.append(trainer.train_step(batches[i])["loss"])
            if i == 0:
                state = trainer.state.optimizer.state
                # a leaf without a gradient (a depth head of an unused scale)
                # has no state and reads 0
                first_grad = {n: (state[p]["exp_avg"] / (1.0 - beta1)).cpu()
                              if "exp_avg" in state[p] else torch.zeros(())
                              for n, p in named}
        program = {"losses": [float(v) for v in losses], "grad": _norms(first_grad),
                   "grad_vector": flat(first_grad),
                   "change": _norms({n: p.detach() - start[n] for n, p in named})}
        del start

        dev.sync(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        steps = 0
        while True:
            trainer.train_step(batches[(checked + steps) % len(batches)])
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        dev.sync(device)
        elapsed = time.perf_counter() - t0
        peak = dev.peak_reserved(device)

        outcome = Outcome(
            end_to_end={"train_samples_per_s": rate(steps * b, elapsed),
                        "peak_reserved_gib": peak / 2 ** 30, "setup_s": setup_s},
            attempted=steps, failed=0, peak_bytes=peak)
        if trace:
            done = checked + steps
            outcome.slice = profile(
                lambda k: trainer.train_step(batches[(done + k) % len(batches)]),
                traffic["trace_units"], tempfile.gettempdir(), device)
            graphs = trainer.train_step.graphs
            outcome.facts.update(
                pool_bytes=dev.pool_bytes(device, graphs.pool if graphs else None),
                flops_per_unit=model_flops_per_step(trainer_config),
                shapes={"batch": b, "height": h, "width": w})
        del trainer, named
        checked_batches = batches[:checked]
        del batches
        dev.free(device)
    reference = reference_run(config, seed, checked_batches, device)
    outcome.checks = checks_from(compare(program, reference), cell.limits)
    return outcome
