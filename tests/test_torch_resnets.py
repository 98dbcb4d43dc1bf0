"""Port parity for DispResNet at the depths 34, 50, 101 and 152 and for
PoseDecoder, against the JAX package on the same numpy inputs and weights
(the checks and random weights of tests/test_torch_zoo.py).

ResNet-34 is built of the basic blocks of ResNet-18 (tests/
test_torch_models.py), 50, 101 and 152 of Bottleneck blocks; the
DispResNet-50 case also returns all four decoder scales (all_scales).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import (
    CASES,
    HW,
    assert_state_equal,
    check_bridge,
    check_export_import,
    check_forward,
    jax_variables,
    nchw,
    port_model,
    random_variables,
)
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.checkpoint import export_torch_state
from unsupervised_pseuso_lidar_tpu_torch.models.depth.resnet_dispnet import num_ch_enc
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(92)
RESNETS = ("DispResNet-34", "DispResNet-50")
# ResNet-50 normalizes 53 times by batch statistics before its last
# BatchNorm in train mode, and the two fp32 forwards drift to ~2e-5 of the
# deepest batch variances there (ResNet-18 holds 1e-5)
DEEP_STATS_RTOL = 1e-4


@pytest.fixture(scope="module")
def resnets():
    return {case: jax_variables(case)[1] for case in RESNETS}


@pytest.mark.parametrize("case", RESNETS)
def test_state_dict_matches_export_torch_state(case, resnets):
    check_bridge(case, resnets[case])


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_resnets_bridge_strictly(depth):
    # ResNet-101 and -152 (23 and 36 blocks in stage 3): the bridge equals
    # the JAX export key for key, and the port's model holds exactly those
    # tensors
    model = jax_build_model("DispResNet", num_layers=depth)
    variables = random_variables(model, jnp.zeros((1, 64, 64, 3)), train=False)
    got = state_dict_from_jax(variables["params"], variables["batch_stats"], "DispResNet")
    assert_state_equal(got, export_torch_state(variables["params"], variables["batch_stats"],
                                               "DispResNet"))
    port = build_model("DispResNet", device="cpu", num_layers=depth)
    port.load_state_dict(got)
    assert len(port.encoder.encoder.layer3) == {101: 23, 152: 36}[depth]


@pytest.mark.parametrize("case,train", [("DispResNet-34", False), ("DispResNet-50", False),
                                        ("DispResNet-50", True)])
def test_forward_matches_jax(case, train, resnets):
    # 48x80 (not a multiple of 32: crop-to-skip and the per-scale crop);
    # sigmoid disparities at atol 1e-4, ResNet-50's four scales; its
    # BatchNorm statistics after a train-mode forward at DEEP_STATS_RTOL
    check_forward(case, resnets[case], (48, 80), train,
                  num_outputs=4 if case == "DispResNet-50" else 1,
                  stats_tol=DEEP_STATS_RTOL)


@pytest.mark.parametrize("case", RESNETS)
def test_reference_export_and_import_match_jax(case, resnets):
    check_export_import(case, resnets[case])


def test_posedecoder_matches_jax(resnets):
    # over the ResNet-50 encoder features (2048 channels at the last level)
    # of two frames, as the port's encoder computes them from the bridged
    # weights: axisangle and translation at atol 1e-6 (0.01-scaled)
    encoder = port_model("DispResNet", resnets["DispResNet-50"], **CASES["DispResNet-50"][2])
    encoder = encoder.encoder.eval()
    frames = [RNG.normal(size=(2, *HW, 3)).astype(np.float32) for _ in range(2)]
    with torch.no_grad():
        feats = [encoder(nchw(f)) for f in frames]
    assert [f.shape[1] for f in feats[0]] == list(num_ch_enc(50))
    jax_feats = [[jnp.asarray(np.moveaxis(f.numpy(), 1, -1)) for f in frame] for frame in feats]
    model = jax_build_model("PoseDecoder")
    variables = random_variables(model, jax_feats)
    ref = jax.jit(model.apply)(variables, jax_feats)
    port = port_model("PoseDecoder", variables, num_ch_enc=num_ch_enc(50))
    with torch.no_grad():
        got = port(feats)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 1, 1, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
