"""Ranks of tests/test_torch_parallel.py: gloo process groups on the CPU.

Kept out of the test module (and out of pytest's collection, by its name)
so that a spawned rank imports torch and the port only, not JAX. Each
group rendezvouses through a FileStore under the test's tmp_path, so
groups of parallel test workers never share a port.

`run_ranks(fn, world, tmp_path, *args)` runs fn(mesh, *args) on `world`
spawned ranks and returns their results (rank order); `start_ranks`
starts them and returns the function that waits for those results. With
`spatial=s` the ranks' mesh is make_mesh(world, spatial=s).
"""

import importlib
import os
import signal
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unsupervised_pseuso_lidar_tpu_torch.data.synthetic import SyntheticTripletDataset
from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import photometric_loss
from unsupervised_pseuso_lidar_tpu_torch.models.layers import BatchNorm2d
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.parallel import spatial
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import make_mesh
from unsupervised_pseuso_lidar_tpu_torch.train import config as config_module
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    make_eval_step,
    make_lr_schedule,
    make_multi_step,
    make_optimizer,
    make_train_step,
    supervised_loss,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHT, WIDTH, BATCH = 64, 96, 4
# the training objective of configs/tpu_v5e.yaml without depth_norm, as in
# tests/test_torch_train.py's full-step comparisons
STEP_SETTINGS = dict(smooth_weight=0.001, smooth_on="disp", depth_norm=False)
# name -> (batch seed, step settings); 'supervised' zeroes the ground
# truth of rows 2-3 outside a band, so the two ranks hold different
# numbers of LiDAR returns
STEP_CASES = {
    "min": (1, dict(loss_mode="min")),
    "mean": (1, dict(loss_mode="mean")),
    "ssim": (1, dict(loss_mode="ssim")),
    "supervised": (1, dict(loss_mode="min", supervised_weight=0.1)),
    "accum": (2, dict(loss_mode="min", accum_steps=2)),
}
GROUP_TIMEOUT_S = 240


def run_ranks(fn, world, tmp_path, *args, device="cpu", spatial=1):
    """fn(mesh, *args) on `world` spawned gloo ranks (one thread each),
    every rank on `device` -> [rank 0's result, ...]; a rank's exception
    is raised here with its traceback. fn is a module-level function of
    an importable module (this one, or tests/torch_spatial_worker.py)."""
    return start_ranks(fn, world, tmp_path, *args, device=device, spatial=spatial)()


def start_ranks(fn, world, tmp_path, *args, device="cpu", spatial=1):
    """Start run_ranks' ranks; returns the function that waits for them
    and returns their results."""
    ctx = mp.get_context("spawn")
    tag = f"{fn.__name__}_{world}x{spatial}"
    store = os.path.join(str(tmp_path), f"store_{tag}")
    outs = [os.path.join(str(tmp_path), f"{tag}_rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_entry,
                         args=(fn.__module__, fn.__name__, r, world, store, outs[r],
                               args, device, spatial))
             for r in range(world)]
    for proc in procs:
        proc.start()

    def wait():
        for proc in procs:
            proc.join(GROUP_TIMEOUT_S)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        assert not alive, f"ranks {alive} of {fn.__name__} still ran after {GROUP_TIMEOUT_S} s"
        results = []
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            assert os.path.exists(out), f"rank {rank} exited with {proc.exitcode} and no result"
            result = torch.load(out, weights_only=False)
            os.remove(out)  # a rank's gradients are tens of MB
            if "error" in result:
                raise AssertionError(f"rank {rank}:\n{result['error']}")
            results.append(result["ok"])
        return results

    return wait


def _entry(module, name, rank, world, store, out, args, device, spatial):
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(world, spatial=spatial, device=device)
        result = {"ok": getattr(importlib.import_module(module), name)(mesh, *args)}
    except BaseException:  # reported to the test with its traceback
        result = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


# --------------------------------------------------------------------------
# the shared inputs
# --------------------------------------------------------------------------


def step_batch(name):
    """The global batch of STEP_CASES[name] (uint8 images, groundtruth)."""
    seed, _ = STEP_CASES[name]
    batch = next(SyntheticTripletDataset(1, BATCH, HEIGHT, WIDTH, seed=seed,
                                         uint8_images=True).batches())
    if name == "supervised":
        gt = batch["groundtruth"].copy()
        gt[2:, : HEIGHT // 2] = 0.0
        batch["groundtruth"] = gt
    return batch


def make_state(weights, device="cpu"):
    """DispResNet-18 + PoseNet with `weights` ({"depth": state dict,
    "pose": state dict}) on `device`, configs/tpu_v5e.yaml's Adam and a
    StepLR."""
    depth = build_model("DispResNet", device=device)
    depth.load_state_dict(weights["depth"])
    pose = build_model("PoseNet", device=device)
    pose.load_state_dict(weights["pose"])
    cfg = config_module.load_config(os.path.join(REPO, "configs", "tpu_v5e.yaml"))
    optimizer = make_optimizer(cfg, depth, pose)
    return TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))


def step_result(state, metrics):
    """Metrics, parameter gradients and BatchNorm running statistics (on
    the CPU)."""
    grads = {}
    for net, model in (("depth", state.depth_model), ("pose", state.pose_model)):
        for key, p in model.named_parameters():
            grads[f"{net}.{key}"] = None if p.grad is None else p.grad.cpu().clone()
    stats = {k: v.cpu().clone() for k, v in state.depth_model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "stats": stats}


def placement(mesh, net, outs, height):
    """Under a spatial mesh, what test_torch_spatial_zoo's
    assert_declared_placement holds: (the placement depth net `net`
    declares for its outputs on an image `height` rows tall
    (banded_outputs), each of `outs`' row counts, and at each output's
    scale this rank's band's and the whole map's row counts). None
    otherwise."""
    if not spatial.row_sharded(mesh):
        return None
    bands = [spatial.band(mesh, height, s) for s in net.scales]
    return (net.banded_outputs(height), tuple(o.shape[2] for o in outs),
            tuple(b.stop - b.start for b in bands),
            tuple(-(-height // 2 ** s) for s in net.scales))


def params_of(state):
    return {f"{net}.{k}": v.detach().clone()
            for net, model in (("depth", state.depth_model), ("pose", state.pose_model))
            for k, v in model.named_parameters()}


# --------------------------------------------------------------------------
# the ranks' work
# --------------------------------------------------------------------------


def _rows(mesh, n):
    return slice(mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size)


def batch_norm_module(channels):
    """A layers.BatchNorm2d with a seeded non-trivial scale and shift."""
    bn = BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    return bn


def reductions(mesh, x, g, pred, target, disp, gt):
    """The step's three batch reductions under the mesh, on this rank's
    rows of the global inputs:
      bn: layers.BatchNorm2d in train mode, the loss sum(out · g) ->
        output rows, running statistics, and the gradients of the input
        rows, the weight and the bias;
      clip: photometric_loss ('ssim' blend, clamp at mean + 0.5 std) ->
        the clamped map's rows;
      supervised: trainer.supervised_loss -> its value and the gradient
        of this rank's disparity rows (of the value every rank holds)."""
    bn = batch_norm_module(x.shape[1])
    bn.mesh = mesh
    leaf = x[_rows(mesh, len(x))].clone().requires_grad_()
    out = bn(leaf)
    (out * g[_rows(mesh, len(g))]).sum().backward()
    rows = _rows(mesh, len(pred))
    clipped = photometric_loss(pred[rows], target[rows], mesh=mesh)
    disp_leaf = disp[_rows(mesh, len(disp))].clone().requires_grad_()
    sup = supervised_loss(disp_leaf, gt[_rows(mesh, len(gt))], mesh)
    sup.backward()
    return {"bn": {"out": out.detach(), "x_grad": leaf.grad, "weight_grad": bn.weight.grad,
                   "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
                   "running_var": bn.running_var},
            "clip": {"map": clipped},
            "supervised": {"value": sup.detach(), "disp_grad": disp_leaf.grad}}


def train_steps(mesh, weights):
    """Every STEP_CASES step from `weights`, the global batch passed to
    the step, beside the step without the mesh on this rank's rows alone
    ("alone": what the rank computes without the collectives); then
    make_multi_step(num_steps=2) against two TrainStep calls ('min',
    batch seeds 1 and 2)."""
    out = {}
    for name, (_, kwargs) in STEP_CASES.items():
        batch = step_batch(name)
        state = make_state(weights)
        step = make_train_step(state, device="cpu", mesh=mesh, **STEP_SETTINGS, **kwargs)
        out[name] = step_result(state, step(batch))
        state = make_state(weights)
        step = make_train_step(state, device="cpu", **STEP_SETTINGS, **kwargs)
        rows = _rows(mesh, BATCH)
        out[name]["alone"] = step_result(state, step({k: v[rows] for k, v in batch.items()}))
    out["multi"] = multi_vs_sequential(weights, mesh)
    out["eval"] = {"mesh": eval_metrics(weights, mesh),
                   "alone": eval_metrics(weights, batch_rows=_rows(mesh, BATCH))}
    return out


def eval_batch():
    """The 'min' case's batch with no ground truth in row 3: rank 1 of 2
    holds one image with depth metrics, rank 0 two."""
    batch = step_batch("min")
    batch["groundtruth"] = batch["groundtruth"].copy()
    batch["groundtruth"][3] = 0.0
    return batch


def eval_metrics(weights, mesh=None, batch_rows=slice(None)):
    """EvalStep's metrics ('ssim' loss, Eigen protocol, pose metrics) on
    eval_batch()'s `batch_rows`, under `mesh` when given."""
    state = make_state(weights)
    step = make_eval_step(state.depth_model, state.pose_model, loss_mode="ssim",
                          eval_protocol="eigen", pose_metrics=True, mesh=mesh,
                          device="cpu")
    metrics, _ = step({k: v[batch_rows] for k, v in eval_batch().items()})
    return {k: float(v) for k, v in metrics.items()}


def card_step(mesh, weights):
    """The 'min' case's step under the mesh on the mesh's device (every
    rank on one card), with the kernels' launches."""
    state = make_state(weights, mesh.device)
    step = make_train_step(state, device=mesh.device, mesh=mesh, loss_mode="min",
                           **STEP_SETTINGS)
    kernels.reset_launch_counts()
    result = step_result(state, step(step_batch("min")))
    result["launches"] = dict(kernels.launch_counts)
    return result


def band_upsample(mesh, inputs, shape):
    """losses/reprojection._full_res_depth of this rank's band of each
    coarse map of `inputs` (scale -> (map [B, 1, h, w], cotangent [B, H,
    W]) of an image of `shape`) on the mesh's device -> scale -> (the
    band's full-resolution rows, the gradient of sum(out · g) w.r.t. the
    band of the map), on the CPU."""
    from unsupervised_pseuso_lidar_tpu_torch.losses.reprojection import _full_res_depth
    from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import band

    height, width = shape
    out = {}
    for scale, (coarse, g) in inputs.items():
        leaf = coarse[:, :, band(mesh, height, scale)].to(mesh.device).requires_grad_()
        full = _full_res_depth(leaf, height, width, mesh, scale)
        (full * g[:, band(mesh, height)].to(mesh.device)).sum().backward()
        out[scale] = (full.detach().cpu(), leaf.grad.cpu())
    return out


def multi_vs_sequential(weights, mesh=None):
    """(the parameters and last metrics after two TrainStep calls, the same
    after make_multi_step(num_steps=2) over the stacked batches)."""
    batches = [step_batch("min"), step_batch("accum")]
    state = make_state(weights)
    step = make_train_step(state, device="cpu", mesh=mesh, loss_mode="min", **STEP_SETTINGS)
    for batch in batches:
        metrics = step(batch)
    sequential = (params_of(state), {k: float(v) for k, v in metrics.items()})
    state = make_state(weights)
    multi = make_multi_step(state, 2, mesh=mesh, device="cpu", loss_mode="min",
                            **STEP_SETTINGS)
    metrics = multi({k: np.stack([b[k] for b in batches]) for k in batches[0]})
    assert state.step == 2
    return sequential, (params_of(state), {k: float(v) for k, v in metrics.items()})


def interrupted_fit(mesh, config):
    """Trainer.fit under the mesh over 3 epochs of 2 synthetic batches;
    rank 1 alone receives SIGTERM during epoch 0 -> (epochs run, step,
    checkpoints on disk)."""
    data = SyntheticTripletDataset(2, config.action.batch_size, *config.image_shape,
                                   seed=0, uint8_images=True)
    trainer = Trainer(config, data, device="cpu", mesh=mesh)
    epochs = []

    def batches(epoch):
        epochs.append(epoch)
        if mesh.rank == 1 and epoch == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return data.batches(epoch)

    trainer.fit(batches)
    return {"epochs": epochs, "step": trainer.state.step,
            "checkpoints": sorted(os.listdir(trainer.checkpoints.directory))
            if os.path.isdir(trainer.checkpoints.directory) else []}

