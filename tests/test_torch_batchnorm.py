"""The port's train-mode BatchNorm2d (models/layers.py) takes its running
statistics from the normalization's own pass.

F.batch_norm writes the batch mean and the unbiased variance into the
module's batch_stats at momentum 1 while it normalizes, and the running
statistics follow flax's rule from them. Held here on the CPU: the output
and the gradients of the input, weight and bias are those of
F.batch_norm(x, None, None, ...) bit for bit; the running statistics lie
within 1e-5 of flax's rule in fp64 (biased variance), and the kernel's
variance of an fp32 batch no farther from the exact one than the fp32
two-pass E[x²] − E[x]² that the port took before; under
frozen_running_statistics the running statistics stay; the state dict is
nn.BatchNorm2d's; and the train step's counter train.bn_one_pass reads the
step's BatchNorms on its eager call, none of the remat recompute's.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from tests.test_torch_bts_train import BTS, RESNET18, _batches, _config, _trainer
from unsupervised_pseuso_lidar_tpu_torch.models.layers import (
    BatchNorm2d,
    frozen_running_statistics,
)
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import BN_ONE_PASS
from unsupervised_pseuso_lidar_tpu_torch.utils import profiling
from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import counter

# (input shape, post-ReLU, bf16 under CPU autocast)
CASES = {
    "relu_8x64x48x160": ((8, 64, 48, 160), True, False),
    "batch1": ((1, 16, 9, 13), False, False),
    "map1x1_batch4": ((4, 32, 1, 1), False, False),
    "bf16_autocast": ((4, 24, 12, 20), False, True),
}
MOMENTUM = 0.3
STATS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name: str, seed: int):
    """(module, x, upstream gradient) of a case: every channel at its own
    scale and offset, the running statistics drawn away from their init."""
    shape, relu, bf16 = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    channels = shape[1]
    scale = torch.rand(channels, generator=gen) * 1.5 + 0.5
    offset = (torch.rand(channels, generator=gen) * 1.5 + 0.5) * torch.where(
        torch.rand(channels, generator=gen) < 0.5, -1.0, 1.0)
    x = torch.randn(shape, generator=gen) * scale[:, None, None] + offset[:, None, None]
    if relu:
        x = torch.relu(x)
    if bf16:
        x = x.to(torch.bfloat16)
    bn = BatchNorm2d(channels, momentum=MOMENTUM).train()
    with torch.no_grad():
        bn.weight.copy_(torch.randn(channels, generator=gen))
        bn.bias.copy_(torch.randn(channels, generator=gen))
        bn.running_mean.copy_(torch.randn(channels, generator=gen))
        bn.running_var.copy_(torch.rand(channels, generator=gen) + 0.5)
    grad = torch.randn(shape, generator=gen).to(x.dtype)
    return bn, x, grad


def _autocast(name: str):
    return torch.autocast("cpu", torch.bfloat16, enabled=CASES[name][2], cache_enabled=False)


def _output_and_grads(fn, x, bn, grad):
    x = x.detach().requires_grad_()
    out = fn(x)
    return (out, *torch.autograd.grad(out, (x, bn.weight, bn.bias), grad))


@pytest.mark.parametrize("case", CASES)
def test_output_and_gradients_are_the_plain_batch_norm_s(case):
    bn, x, grad = _case(case, 11)
    with _autocast(case):
        got = _output_and_grads(bn, x, bn, grad)
        plain = _output_and_grads(
            lambda t: F.batch_norm(t, None, None, bn.weight, bn.bias, True, 0.0, bn.eps),
            x, bn, grad)
    assert got[0].dtype == x.dtype
    for g, p, what in zip(got, plain, ("output", "dx", "dweight", "dbias")):
        assert torch.equal(g, p), what


def _relative(got: torch.Tensor, exact: torch.Tensor) -> float:
    # over the channels: a running mean that the blend brings near 0 has
    # no elementwise bound in any fp32 formula (the old one's read 5.2e-5)
    return float(torch.linalg.vector_norm(got.double() - exact)
                 / torch.linalg.vector_norm(exact))


@pytest.mark.parametrize("case", CASES)
def test_running_statistics_follow_flax_rule(case):
    bn, x, _ = _case(case, 12)
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    with _autocast(case), torch.no_grad():
        bn(x)
    xd = x.double()
    n = x.numel() // x.shape[1]
    batch_var = xd.var(dim=(0, 2, 3), unbiased=False)
    exact_mean = (1 - MOMENTUM) * mean0.double() + MOMENTUM * xd.mean(dim=(0, 2, 3))
    exact_var = (1 - MOMENTUM) * var0.double() + MOMENTUM * batch_var
    for key, got, exact in (("mean", bn.running_mean, exact_mean),
                            ("var", bn.running_var, exact_var)):
        assert got.dtype == torch.float32
        assert _relative(got, exact) <= STATS_RTOL, (key, _relative(got, exact))
    assert int(bn.num_batches_tracked) == 1
    # the kernel's variance against the fp32 two-pass E[x²] − E[x]² that
    # the port took before; a bf16 input squares exactly in fp32, so there
    # both sit at fp32's rounding (2.7e-7 and 1.8e-7 at worst over 40 seeds)
    # and either may be the nearer
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    two_pass = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    kernel = bn.batch_stats[1].double() * (n - 1) / n
    assert _relative(kernel, batch_var) <= STATS_RTOL
    if x.dtype == torch.float32:
        assert _relative(kernel, batch_var) <= _relative(two_pass, batch_var)


@pytest.mark.parametrize("case", CASES)
def test_frozen_running_statistics_leave_the_running_buffers(case):
    bn, x, grad = _case(case, 13)
    with _autocast(case), torch.no_grad():
        bn(x)  # batch_stats holds a batch
    before = {k: v.clone() for k, v in bn.state_dict().items() if k not in ("weight", "bias")}
    with _autocast(case), frozen_running_statistics():
        out = bn(x.detach().requires_grad_())
        out.backward(grad)
    assert bn.one_pass_calls == 1
    assert sorted(before) == ["num_batches_tracked", "running_mean", "running_var"]
    for key, value in before.items():
        assert torch.equal(bn.state_dict()[key], value), key


def test_state_dict_keys_are_nn_batch_norm_s():
    port, plain = BatchNorm2d(12), nn.BatchNorm2d(12)
    assert list(port.state_dict()) == list(plain.state_dict())
    port.load_state_dict(plain.state_dict(), strict=True)
    assert "batch_stats" in dict(port.named_buffers())


@pytest.mark.parametrize("depth,remat,calls", [
    (RESNET18, False, 20),
    (RESNET18, True, 20),
    (BTS, False, 175),
], ids=["resnet18", "resnet18_remat", "bts128"])
def test_the_step_counts_its_one_pass_batch_norms(tmp_path, monkeypatch, depth, remat, calls):
    monkeypatch.setattr(profiling, "COUNTERS", {})
    config = _config(depth)
    config["trainer"]["action"]["remat"] = remat
    trainer = _trainer(config, tmp_path)
    step = trainer.train_step
    assert step.remat == remat
    modules = [m for m in trainer.state.depth_model.modules() if isinstance(m, BatchNorm2d)]
    assert len(modules) == calls
    batches = _batches()
    step(batches[0])
    assert counter(BN_ONE_PASS) == calls
    assert all(m.one_pass_calls == int(m.num_batches_tracked) == 1 for m in modules)
    # later calls of the same signature count nothing
    step(batches[1])
    assert counter(BN_ONE_PASS) == calls
