"""How far the fp32 gradients of tests/test_torch_spatial_zoo.py's forward
units lie from an fp64 evaluation of the same function (CPU):

    python -m tests.torch_spatial_zoo_fp64 [resnet] [stn] ...

For each FORWARDS unit named (default: resnet, stn) it prints the rel L2
distance of the parameter gradient of Σ output · cotangent, in train
mode, from the whole image's fp64 evaluation: of the plain one-process
fp32 forward (F.batch_norm), of the whole image under a one-rank data
mesh (layers._GlobalBatchNorm) and of the bands summed over the unit's
ranks (2 for StnDispNet, 4 for DispResNet). This is what chose those
tests' references: the one-rank mesh for the BatchNorm nets, and
STN_GRAD_RTOL for StnDispNet with its STN. About a minute a unit.
"""

import sys
import tempfile

import torch

from tests import test_torch_spatial_zoo as zoo_test
from tests import torch_parallel_worker as worker
from tests import torch_spatial_zoo_worker as zoo
from unsupervised_pseuso_lidar_tpu_torch.models.depth import stn_dispnet

RANKS = {"resnet": 4, "stn": 2, "stn_off": 2, "dispnets": 2}


def _affine_grid(theta, height, width):
    """stn_dispnet.affine_grid in theta's dtype (the port's is fp32)."""
    xs = (torch.arange(width, dtype=theta.dtype) * 2 + 1) / width - 1
    ys = (torch.arange(height, dtype=theta.dtype) * 2 + 1) / height - 1
    base = torch.stack([xs[None, :].expand(height, width), ys[:, None].expand(height, width),
                        torch.ones(height, width, dtype=theta.dtype)], dim=-1)
    return torch.einsum("bij,hwj->bhwi", theta, base)


def main(names):
    torch.set_num_threads(1)
    weights = zoo_test._port_weights(zoo_test._weights())
    inputs = zoo_test._unit_inputs()
    stn_dispnet.affine_grid = _affine_grid  # this process's fp64 forward only
    flat, rel = zoo_test._flat, zoo_test._rel_l2
    for name in names:
        exact = zoo.forward(None, weights, name, inputs, True, torch.float64)[1]
        plain = zoo.forward(None, weights, name, inputs, True)[1]
        spatial = RANKS[name]
        with tempfile.TemporaryDirectory() as tmp:
            one_rank = worker.run_ranks(zoo.forward, 1, tmp, weights, name, inputs, True)[0][1]
            bands = zoo_test._summed([r[1] for r in worker.run_ranks(
                zoo.forward, spatial, tmp, weights, name, inputs, True, spatial=spatial)])
        print(f"{name}: rel L2 from fp64 — plain {rel(flat(plain), flat(exact)):.3g}, "
              f"one-rank mesh {rel(flat(one_rank), flat(exact)):.3g}, "
              f"{spatial} bands {rel(flat(bands), flat(exact)):.3g}", flush=True)
        if name == "stn":
            for part, keys in zoo_test.stn_parts(exact).items():
                if part == "stn_cancelled":  # 0 but for rounding: no relative distance
                    continue
                print(f"  {part}: plain {zoo_test.part_rel(plain, exact, keys):.3g}, "
                      f"one-rank mesh {zoo_test.part_rel(one_rank, exact, keys):.3g}, "
                      f"{spatial} bands {zoo_test.part_rel(bands, exact, keys):.3g}; worst "
                      f"leaf: plain {zoo_test.worst_leaf(plain, exact, keys)}, "
                      f"bands {zoo_test.worst_leaf(bands, exact, keys)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["resnet", "stn"])
