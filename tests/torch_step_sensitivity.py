"""How steady the port's full training step is at a batch seed: the
relative L2 change of every depth-parameter gradient of one 'min' step
(the full-step settings of tests/test_torch_zoo_train.py) when every depth
weight is scaled by (1 + eps · N(0, 1)). Two fp32 implementations of the
same step differ by about that much, so a seed whose gradient moves a lot
here cannot hold the parity bounds there.

    JAX_PLATFORMS=cpu python -m tests.torch_step_sensitivity [--seeds 1 2 3]

Prints, per model and seed, the median and worst key at eps 1e-7 and
1e-6 (CPU; not a test: it asserts nothing).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_train import STEP_SETTINGS, _rel_l2
from tests.test_torch_zoo import CASES, jax_variables, port_model
from tests.test_torch_zoo_train import CONFIG, GN_CANCELLED, HEIGHT, WIDTH
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
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


def _pose_params():
    """tests/test_torch_zoo_train.py's pose_variables fixture."""
    pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, HEIGHT, WIDTH, 3), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(pose.init)(jax.random.PRNGKey(1), img,
                                                          [img, img])["params"])
    head = params["TorchConv_7"]["Conv_0"]
    head["bias"] = (np.random.default_rng(7).normal(size=(2, 6))
                    * np.array([0.002] * 3 + [0.005] * 3) / 0.06).reshape(-1).astype(np.float32)
    return params


def gradients(case, depth_vars, pose_params, batch, eps, seed):
    """{key: gradient} of the depth net after one step, weights perturbed."""
    name = CASES[case][0]
    depth = port_model(name, depth_vars, image_shape=(HEIGHT, WIDTH), **CASES[case][2])
    pose = build_model("PoseNet", device="cpu")
    pose.load_state_dict(state_dict_from_jax(pose_params, {}, "PoseNet"))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed)
        for p in depth.parameters():
            p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
    optimizer = make_optimizer(config.load_config(CONFIG), depth, pose)
    state = TrainState(depth, pose, optimizer, make_lr_schedule(optimizer, 30, 0.1, 1))
    make_train_step(state, device="cpu", loss_mode="min", **STEP_SETTINGS)(batch)
    return {k: p.grad.clone() for k, p in depth.named_parameters()
            if p.grad is not None and f"{name}:{k}" not in GN_CANCELLED}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", nargs="+", default=["DispNetS", "StnDispNet-stn"])
    parser.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3, 4])
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    pose_params = _pose_params()
    for case in args.cases:
        _, depth_vars = jax_variables(case, hw=(HEIGHT, WIDTH))
        for seed in args.seeds:
            batch = next(SyntheticTripletDataset(1, 2, HEIGHT, WIDTH, seed=seed,
                                                 uint8_images=True).batches())
            base = gradients(case, depth_vars, pose_params, batch, 0.0, 0)
            parts = []
            for eps in (1e-7, 1e-6):
                moved = gradients(case, depth_vars, pose_params, batch, eps, 1)
                rels = [_rel_l2(moved[k].numpy(), base[k].numpy()) for k in base]
                parts.append(f"eps {eps:g}: median {np.median(rels):.3g} "
                             f"worst {max(rels):.3g}")
            print(f"{case} seed {seed}: " + " | ".join(parts), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
