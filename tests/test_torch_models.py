"""Port parity: the weight bridge and the models of the port.

state_dict_from_jax must give exactly what the JAX package's
export_torch_state gives, load into the port's models with strict=True,
and with those weights the port's DispResNet-18 (eval), PoseNet and
PoseFc must reproduce the flax apply(train=False) outputs in fp32.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.checkpoint import export_torch_state
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
RNG = np.random.default_rng(3)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _random_batch_stats(stats):
    # non-trivial running statistics, so the BatchNorm mapping is exercised
    return jax.tree.map(
        lambda a: RNG.uniform(0.5, 1.5, a.shape).astype(np.float32), stats
    )


@pytest.fixture(scope="module")
def jax_depth():
    model = jax_build_model("DispResNet")
    img = jnp.zeros((1, 64, 128, 3), jnp.float32)
    variables = jax.jit(partial(model.init, train=False))(jax.random.PRNGKey(0), img)
    params = _numpy_tree(variables["params"])
    stats = _random_batch_stats(_numpy_tree(variables["batch_stats"]))
    return model, params, stats


@pytest.fixture(scope="module")
def jax_pose():
    # s2d_convs=0: the JAX default blocks the first two convs with
    # space-to-depth, which is exact for the 7x7 conv but not for the 5x5
    # one (odd/even phase slip at torch padding 2, ~1e-3 on the poses);
    # the plain flax convs have the torch semantics the port implements
    model = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, 64, 128, 3), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), img, [img, img])
    return model, _numpy_tree(variables["params"])


POSEFC_HW = (128, 128)


def _posefc(hw):
    """Flax PoseFc variables at image size hw, every Dense layer random
    (the last one is zero-initialized, which would hide its mapping)."""
    model = jax_build_model("PoseFc")
    img = jnp.zeros((1, *hw, 3), jnp.float32)
    params = _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(2), img, [img, img])["params"])
    for i in range(3):
        dense = params[f"Dense_{i}"]
        dense["kernel"] = RNG.normal(0, 0.3, dense["kernel"].shape).astype(np.float32)
        dense["bias"] = RNG.normal(0, 0.1, dense["bias"].shape).astype(np.float32)
    return model, params


@pytest.fixture(scope="module")
def jax_posefc():
    return _posefc(POSEFC_HW)


def _variables(name, jax_depth, jax_pose, jax_posefc):
    return {"DispResNet": (jax_depth[1], jax_depth[2]), "PoseNet": (jax_pose[1], {}),
            "PoseFc": (jax_posefc[1], {})}[name]


@pytest.mark.parametrize("name", ["DispResNet", "PoseNet", "PoseFc"])
def test_state_dict_matches_export_torch_state(name, jax_depth, jax_pose, jax_posefc):
    params, stats = _variables(name, jax_depth, jax_pose, jax_posefc)
    ref = export_torch_state(params, stats, name)
    got = state_dict_from_jax(params, stats, name)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("name", ["DispResNet", "PoseNet", "PoseFc"])
def test_weight_bridge_round_trip_is_strict(name, jax_depth, jax_pose, jax_posefc):
    # every parameter and buffer of the port's model is covered by the
    # bridge and nothing else is: a model change that drops or adds a
    # parameter fails here
    params, stats = _variables(name, jax_depth, jax_pose, jax_posefc)
    model = build_model(name, device="cpu", image_shape=POSEFC_HW)
    state = state_dict_from_jax(params, stats, name)
    model.load_state_dict(state, strict=True)
    loaded = model.state_dict()
    assert sorted(loaded) == sorted(state)
    for key, value in state.items():
        assert torch.equal(loaded[key], value), key


@pytest.mark.parametrize("hw", [(64, 128), (48, 80)])
def test_dispresnet_matches_flax(hw, jax_depth):
    # fp32 both sides (JAX at HIGHEST matmul precision, conftest); 48x80 is
    # not a multiple of 32, which exercises crop-to-skip and the final
    # image-shape crop: atol 1e-4 on sigmoid disparities
    model, params, stats = jax_depth
    img = RNG.normal(size=(2, *hw, 3)).astype(np.float32)
    ref = jax.jit(partial(model.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(img)
    )
    port = build_model("DispResNet", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, stats, "DispResNet"))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))))
    assert len(got) == len(ref) == 1
    assert got[0].shape == (2, 1, *hw)
    np.testing.assert_allclose(
        got[0].numpy().transpose(0, 2, 3, 1), np.asarray(ref[0]), atol=1e-4
    )


def test_posenet_matches_flax(jax_pose):
    # [tgt, ref0, ref1] concatenated on channels; atol 1e-5 on the
    # 0.06-scaled poses
    model, params = jax_pose
    imgs = [RNG.normal(size=(2, 64, 128, 3)).astype(np.float32) for _ in range(3)]
    ref = model.apply({"params": params}, jnp.asarray(imgs[0]),
                      [jnp.asarray(imgs[1]), jnp.asarray(imgs[2])])
    port = build_model("PoseNet", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, {}, "PoseNet"))
    t = [torch.from_numpy(np.ascontiguousarray(i.transpose(0, 3, 1, 2))) for i in imgs]
    with torch.no_grad():
        got = port(t[0], t[1:])
    assert got.shape == (2, 2, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _nchw_list(imgs):
    return [torch.from_numpy(np.ascontiguousarray(i.transpose(0, 3, 1, 2))) for i in imgs]


@pytest.mark.parametrize("hw", [POSEFC_HW, (96, 320)])
def test_posefc_matches_flax(hw, jax_posefc):
    # the FC width follows the image size (12·ceil(H/128)·ceil(W/128));
    # 96x320 is non-square and not a multiple of 128. atol 1e-5; the
    # rotation half is exactly 0 on both sides
    model, params = jax_posefc if hw == POSEFC_HW else _posefc(hw)
    imgs = [RNG.normal(size=(2, *hw, 3)).astype(np.float32) for _ in range(3)]
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(imgs[0]),
                                 [jnp.asarray(imgs[1]), jnp.asarray(imgs[2])]))
    port = build_model("PoseFc", device="cpu", image_shape=hw)
    port.load_state_dict(state_dict_from_jax(params, {}, "PoseFc"))
    t = _nchw_list(imgs)
    with torch.no_grad():
        got = port(t[0], t[1:]).numpy()
    assert got.shape == (2, 2, 6) and float(np.abs(ref[..., 3:]).max()) > 1e-3
    assert (got[..., :3] == 0).all() and (ref[..., :3] == 0).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_posefc_loads_a_reference_state_dict(jax_posefc):
    # the reference schema (fc_loc.0 columns in torch's CHW flatten order),
    # as the JAX package exports it, loads strictly into the port and gives
    # the flax outputs: the port flattens CHW like the reference
    model, params = jax_posefc
    reference = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in export_torch_state(params, {}, "PoseFc").items()}
    port = build_model("PoseFc", device="cpu", image_shape=POSEFC_HW)
    port.load_state_dict(reference, strict=True)
    imgs = [RNG.normal(size=(1, *POSEFC_HW, 3)).astype(np.float32) for _ in range(3)]
    ref = model.apply({"params": params}, jnp.asarray(imgs[0]),
                      [jnp.asarray(imgs[1]), jnp.asarray(imgs[2])])
    t = _nchw_list(imgs)
    with torch.no_grad():
        np.testing.assert_allclose(port(t[0], t[1:]).numpy(), np.asarray(ref), atol=1e-5)


def test_posefc_seeded_init_and_rotation_gradient():
    # seeded: the last Linear is zero (poses start at 0), the others are
    # random with zero biases; the rotation half passes no gradient
    gen = torch.Generator().manual_seed(3)
    model = build_model("PoseFc", generator=gen, device="cpu", image_shape=(64, 128))
    assert model.fc_loc[0].in_features == 12 * 1 * 1
    assert float(model.fc_loc[4].weight.abs().max()) == 0.0
    assert float(model.fc_loc[0].weight.std()) > 0
    imgs = [torch.randn(2, 3, 64, 128, generator=gen) for _ in range(3)]
    out = model(imgs[0], imgs[1:])
    assert float(out.abs().max()) == 0.0
    (out[..., :3].sum() * 1e3).backward()
    assert all(p.grad is None or float(p.grad.abs().max()) == 0.0
               for p in model.parameters())


def test_seeded_init_is_reproducible():
    # explicit generators: the same seed gives the same weights
    a = build_model("PoseNet", generator=torch.Generator().manual_seed(7), device="cpu")
    b = build_model("PoseNet", generator=torch.Generator().manual_seed(7), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert all(float(v.abs().sum()) == 0.0
               for k, v in a.state_dict().items() if k.endswith("bias"))


def test_jax_posenet_space_to_depth_fault(jax_pose):
    # ROADMAP "Faults": the JAX PoseNet default (s2d_convs=2) rewrites its
    # 5x5 stride-2 conv over space-to-depth input one pixel off, so it is
    # NOT the plain conv its parameters describe; the port follows the
    # plain conv (s2d_convs=0, matched above). This records the size of
    # the gap on the poses; it fails once the JAX rewrite is fixed, and the
    # parity tests can then use the default model.
    model, params = jax_pose
    imgs = [jnp.asarray(RNG.normal(size=(2, 64, 128, 3)).astype(np.float32))
            for _ in range(3)]
    plain = model.apply({"params": params}, imgs[0], imgs[1:])
    blocked = jax_build_model("PoseNet").apply({"params": params}, imgs[0], imgs[1:])
    gap = float(jnp.abs(plain - blocked).max())
    assert gap > 1e-4, gap
