"""Port parity for the rest of the model zoo: DispNetS, StnDispNet (with
and without its spatial transformer), the layers they are built of
(TorchConvTranspose, DownsampleConvBN, DownsampleConvGN, UpconvGN) and
the resampling they need (resize_nearest, affine_grid, grid_sample with
align_corners=False), against the JAX package on the same numpy inputs
and weights. tests/test_torch_resnets.py holds DispResNet at the depths
34 to 152 and PoseDecoder to the same checks (check_* below).

The flax variables are not drawn by flax's init (a jitted init of each
model would cost a compile): their shapes come from jax.eval_shape of the
init, their values from a seeded numpy generator (random_variables), and
the port loads them through weights.state_dict_from_jax with
strict=True. Images are NHWC on the JAX side and NCHW on the port's. JAX
runs fp32 at HIGHEST matmul precision (tests/conftest.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.models import layers as jax_layers
from unsupervised_pseuso_lidar_tpu.models.depth import stn_dispnet as jax_stn
from unsupervised_pseuso_lidar_tpu.ops import resample as jax_resample
from unsupervised_pseuso_lidar_tpu.train.checkpoint import (
    export_torch_state,
    import_torch_state,
)
from unsupervised_pseuso_lidar_tpu_torch.models import layers
from unsupervised_pseuso_lidar_tpu_torch.models.depth.stn_dispnet import affine_grid
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.ops import resample
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import grid_sample as grid_sample_port
from unsupervised_pseuso_lidar_tpu_torch.train.checkpoint import (
    load_reference_state,
    reference_state,
)
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
HW = (64, 96)
# sigmoid disparities / depths of a forward: max abs error against JAX
FORWARD_ATOL = 1e-4
# BatchNorm running statistics after a train-mode forward, rel and abs
# (test_torch_train's bound for ResNet-18)
STATS_RTOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def random_variables(model, *args, seed=0, **kwargs):
    """Flax variables of `model` as nested dicts of numpy arrays: shapes
    from jax.eval_shape of its init (no compile), values seeded — kernels
    U(±sqrt(3 / fan_in)) (unit output variance), biases and norm shifts
    N(0, 0.1), norm scales U(0.5, 1.5), running means N(0, 0.2) and
    variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(partial(model.init, **kwargs), jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            bound = np.sqrt(3.0 / fan_in)
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1 if name == "bias" else 0.2, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, var

    def plain(d):
        return {k: plain(v) if isinstance(v, dict) else v for k, v in dict(d).items()}

    return {k: plain(jax.tree_util.tree_map_with_path(draw, v)) for k, v in shapes.items()}


def port_model(name, variables, *, image_shape=None, **kwargs):
    """The port's `name` on the CPU with the flax variables bridged in
    (strict)."""
    model = build_model(name, device="cpu", image_shape=image_shape, **kwargs)
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {}), name))
    return model


def assert_state_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)


# --------------------------------------------------------------------------
# resampling
# --------------------------------------------------------------------------


@pytest.mark.parametrize("src,out", [((64, 96), (16, 24)), ((352, 1216), (88, 304)),
                                     ((7, 11), (3, 5)), ((5, 6), (11, 13))])
def test_resize_nearest_matches_jax(src, out):
    # exact: the same fp32 index formula (a BTS 8x8 depth map to the
    # next level, KITTI's serving size, ratios that are not integers, and
    # an upsample)
    rng = np.random.default_rng(91)
    img = rng.normal(size=(2, *src, 3)).astype(np.float32)
    ref = np.asarray(jax_resample.resize_nearest(jnp.asarray(img), *out))
    got = resample.resize_nearest(nchw(img), *out)
    np.testing.assert_array_equal(nhwc(got), ref)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners):
    # bilinear, zeros padding, samples in and out of frame; fp32 atol 1e-6
    rng = np.random.default_rng(91)
    img = rng.uniform(0, 1, (2, 9, 13, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 7, 5, 2)).astype(np.float32)
    ref = jax_resample.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                   align_corners=align_corners)
    got = resample.grid_sample(nchw(img), torch.from_numpy(grid), align_corners=align_corners)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-6)


def test_affine_grid_matches_jax_and_torch():
    # JAX's formula (atol 1e-6), which is F.affine_grid(align_corners=
    # False)'s grid up to rounding (atol 1e-5)
    rng = np.random.default_rng(91)
    theta = (np.array([1, 0, 0, 0, 1, 0], np.float32)
             + rng.normal(0, 0.2, (3, 6)).astype(np.float32)).reshape(3, 2, 3)
    ref = np.asarray(jax_stn.affine_grid(jnp.asarray(theta), 12, 40))
    got = affine_grid(torch.from_numpy(theta), 12, 40)
    assert got.shape == (3, 12, 40, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    torch_grid = torch.nn.functional.affine_grid(torch.from_numpy(theta), (3, 1, 12, 40),
                                                 align_corners=False)
    np.testing.assert_allclose(got.numpy(), torch_grid.numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def _bridge(variables, mapping):
    """A flax layer's variables -> the port layer's state dict, by
    {flax path: (torch prefix, kind)}."""
    state = {}
    for flax_path, (prefix, kind) in mapping.items():
        leaf = variables["params"][flax_path]
        if kind in ("conv", "convT"):
            leaf = leaf.get("Conv_0", leaf)
            axes = (3, 2, 0, 1) if kind == "conv" else (2, 3, 0, 1)
            state[f"{prefix}.weight"] = np.transpose(leaf["kernel"], axes)
            state[f"{prefix}.bias"] = leaf["bias"]
        else:  # gn, bn
            state[f"{prefix}.weight"], state[f"{prefix}.bias"] = leaf["scale"], leaf["bias"]
            if kind == "bn":
                stats = variables["batch_stats"][flax_path]
                state[f"{prefix}.running_mean"] = stats["mean"]
                state[f"{prefix}.running_var"] = stats["var"]
                state[f"{prefix}.num_batches_tracked"] = np.array(0)
    return {k.lstrip("."): torch.from_numpy(np.array(v)) for k, v in state.items()}


def test_conv_transpose_matches_jax():
    # ConvTranspose2d(3, s2, p1, output_padding 1): output 2x the input;
    # fp32 atol 1e-5
    rng = np.random.default_rng(91)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    flax_layer = jax_layers.TorchConvTranspose(4)
    variables = random_variables(flax_layer, jnp.asarray(x))
    port = layers.conv_transpose(6, 4)
    port.load_state_dict(_bridge({"params": {"": variables["params"]}}, {"": ("", "convT")}))
    got = port(nchw(x))
    assert got.shape == (2, 4, 10, 14)
    np.testing.assert_allclose(nhwc(got), np.asarray(flax_layer.apply(variables, jnp.asarray(x))),
                               atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_downsample_conv_bn_matches_jax(train):
    # the norm after the ReLU; in train mode the batch's statistics, and
    # the running statistics after it (flax's biased variance) at rel 1e-5
    rng = np.random.default_rng(91)
    x = rng.normal(size=(3, 9, 12, 5)).astype(np.float32)
    flax_layer = jax_layers.DownsampleConvBN(16, 5)
    variables = random_variables(flax_layer, jnp.asarray(x), train=False)
    port = layers.DownsampleConvBN(5, 16, 5)
    port.load_state_dict(_bridge(variables, {"TorchConv_0": ("0", "conv"),
                                             "BatchNorm_0": ("2", "bn"),
                                             "TorchConv_1": ("3", "conv")}))
    port.train(train)
    got = port(nchw(x))
    if train:
        ref, mutated = flax_layer.apply(variables, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
        stats = mutated["batch_stats"]["BatchNorm_0"]
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(port[2], f"running_{name}").numpy(),
                                       np.asarray(stats[name]), rtol=STATS_RTOL, atol=1e-6)
    else:
        ref = flax_layer.apply(variables, jnp.asarray(x), train=False)
    assert got.shape == (3, 16, 5, 6)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_group_norm_blocks_match_jax(scale):
    # DownsampleConvGN and UpconvGN with flax's GroupNorm epsilon 1e-6: at
    # input scale 1e-3 the group variances are ~1e-6, where torch's
    # default 1e-5 would be off by a factor ~3 (rel 1e-4 of the largest
    # output)
    rng = np.random.default_rng(91)
    x = (scale * rng.normal(size=(2, 12, 16, 3))).astype(np.float32)
    down = jax_layers.DownsampleConvGN(32)
    down_vars = random_variables(down, jnp.asarray(x))
    for conv in ("TorchConv_0", "TorchConv_1"):  # no bias: scale-free convs
        down_vars["params"][conv]["Conv_0"]["bias"][:] = 0.0
    mid = down.apply(down_vars, jnp.asarray(x))
    up = jax_layers.UpconvGN(16)
    up_vars = random_variables(up, mid)
    ref_mid, ref = np.asarray(mid), np.asarray(up.apply(up_vars, mid))
    port_down = layers.DownsampleConvGN(3, 32)
    port_down.load_state_dict(_bridge(down_vars, {
        "TorchConv_0": ("0", "conv"), "GroupNorm_0": ("1", "gn"),
        "TorchConv_1": ("3", "conv"), "GroupNorm_1": ("4", "gn")}))
    port_up = layers.UpconvGN(32, 16)
    port_up.load_state_dict(_bridge(up_vars, {"TorchConvTranspose_0": ("0", "convT"),
                                              "GroupNorm_0": ("1", "gn")}))
    assert port_down[1].eps == port_up[1].eps == 1e-6
    got_mid = port_down(nchw(x))
    got = port_up(got_mid)
    for g, r in ((got_mid, ref_mid), (got, ref)):
        np.testing.assert_allclose(nhwc(g), r, atol=1e-4 * float(np.abs(r).max()))


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

# case -> (model name, JAX constructor kwargs, port kwargs); the port's
# StnDispNet takes the image shape its localization Linear is built for
CASES = {
    "DispNetS": ("DispNetS", {}, {}),
    "StnDispNet": ("StnDispNet", {}, {}),
    "StnDispNet-stn": ("StnDispNet", {"use_stn": True}, {"use_stn": True}),
    "DispResNet-34": ("DispResNet", {"num_layers": 34}, {"num_layers": 34}),
    "DispResNet-50": ("DispResNet", {"num_layers": 50, "all_scales": True},
                      {"num_layers": 50, "all_scales": True}),
}
ZOO = ("DispNetS", "StnDispNet", "StnDispNet-stn")


def jax_variables(case, hw=HW, seed=0):
    """(flax model, its random variables) of a CASES entry at size hw."""
    name, jax_kwargs, _ = CASES[case]
    model = jax_build_model(name, **jax_kwargs)
    img = jnp.zeros((1, *hw, 3), jnp.float32)
    variables = random_variables(model, img, seed=seed, train=False)
    if case == "StnDispNet-stn":
        # the last Dense is zero at init: give it weights, or the STN's
        # transform (and its mapping) would be the identity
        rng = np.random.default_rng(1000 + seed)
        last = variables["params"]["Dense_3"]
        last["kernel"] = rng.normal(0, 0.02, last["kernel"].shape).astype(np.float32)
        last["bias"] = np.array([1, 0, 0, 0, 1, 0], np.float32) + rng.normal(
            0, 0.05, 6).astype(np.float32)
    return model, variables


def check_bridge(case, variables):
    """The bridge gives exactly the JAX export's reference-schema state
    dict (the identity STN branch of a StnDispNet without STN included),
    and it loads strictly into the port's model. A live STN branch at
    64x96 is bridged as it is, where the export writes the identity at
    the reference's size (test_stn_branch_follows_jax_both_ways)."""
    name, _, port_kwargs = CASES[case]
    params, stats = variables["params"], variables.get("batch_stats", {})
    got = state_dict_from_jax(params, stats, name)
    ref = export_torch_state(params, stats, name)
    if case == "StnDispNet-stn":
        live = {k for k in got if k.startswith(("localization.", "fc_loc."))}
        assert live == {k for k in ref if k.startswith(("localization.", "fc_loc."))}
        assert got["fc_loc.0.weight"].shape == (1280, 32 * 2 * 3)
        got = {k: v for k, v in got.items() if k not in live}
        ref = {k: v for k, v in ref.items() if k not in live}
    assert_state_equal(got, ref)
    model = port_model(name, variables, image_shape=HW, **port_kwargs)
    assert_state_equal(model.state_dict(), state_dict_from_jax(params, stats, name))


def check_forward(case, variables, hw, train, num_outputs, scale=1.0, stats_tol=STATS_RTOL,
                  seed=91):
    """The port's forward against flax apply on a random batch at hw:
    every output at atol FORWARD_ATOL · scale; in train mode the BatchNorm
    running statistics after it at rel and abs stats_tol."""
    name, jax_kwargs, port_kwargs = CASES[case]
    model = jax_build_model(name, **jax_kwargs)
    port = port_model(name, variables, image_shape=hw, **port_kwargs)
    port.train(train)
    img = np.random.default_rng(seed).normal(size=(2, *hw, 3)).astype(np.float32)
    mutated = {}
    if train:
        ref, mutated = jax.jit(partial(model.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(img))
    else:
        ref = jax.jit(partial(model.apply, train=False))(variables, jnp.asarray(img))
    got = port(nchw(img))
    assert len(got) == len(ref) == num_outputs
    for g, r in zip(got, ref):
        assert g.shape[2:] == r.shape[1:3]
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=FORWARD_ATOL * scale)
    if mutated.get("batch_stats"):
        buffers = dict(port.named_buffers())
        ref_state = state_dict_from_jax(variables["params"], mutated["batch_stats"], name)
        for key, value in ref_state.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buffers[key].numpy(), value.numpy(),
                                           rtol=stats_tol, atol=stats_tol, err_msg=key)


def check_export_import(case, variables):
    """Export: the port's reference_state equals export_torch_state of the
    same weights. Import: a reference state dict of other weights loaded
    by the port equals JAX's import_torch_state of it, bridged back."""
    name, _, port_kwargs = CASES[case]
    params, stats = variables["params"], variables.get("batch_stats", {})
    port = port_model(name, variables, image_shape=HW, **port_kwargs)
    assert_state_equal(reference_state(port), export_torch_state(params, stats, name))
    _, other = jax_variables(case, seed=1)
    blob = export_torch_state(other["params"], other.get("batch_stats", {}), name)
    load_reference_state(port, {k: torch.from_numpy(np.array(v)) for k, v in blob.items()})
    new_params, new_stats = import_torch_state(params, stats, blob, name)
    assert_state_equal(port.state_dict(), state_dict_from_jax(new_params, new_stats, name))


@pytest.fixture(scope="module")
def zoo():
    return {case: jax_variables(case)[1] for case in ZOO}


@pytest.mark.parametrize("case", ZOO)
def test_state_dict_matches_export_torch_state(case, zoo):
    check_bridge(case, zoo[case])


@pytest.mark.parametrize("case,train", [("DispNetS", False), ("DispNetS", True),
                                        ("StnDispNet", False), ("StnDispNet-stn", False),
                                        ("StnDispNet-stn", True)])
def test_forward_matches_jax(case, train, zoo):
    # DispNetS at 48x80 (not a multiple of 128: every crop_like bites),
    # its four disparities 10·sigmoid + 0.01 at atol 1e-3 (rel 1e-4 of
    # their range) and its BatchNorm statistics in train mode; StnDispNet
    # at 64x96 (GroupNorm: train and eval mode are one function)
    if case == "DispNetS":
        check_forward(case, zoo[case], (48, 80), train, num_outputs=4, scale=10.0)
    else:
        check_forward(case, zoo[case], HW, train, num_outputs=1)


def test_dispnets_sizes_crop_like_the_reference(zoo):
    # a size that is not a multiple of 128: each scale s is the encoder's
    # ceil(H/2^s), the finest the image's own
    port = port_model("DispNetS", zoo["DispNetS"]).eval()
    with torch.no_grad():
        out = port(torch.zeros(1, 3, 75, 250))
    assert [tuple(d.shape[2:]) for d in out] == [(75, 250), (38, 125), (19, 63), (10, 32)]


# --------------------------------------------------------------------------
# reference-schema export and import
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ZOO)
def test_reference_export_and_import_match_jax(case, zoo):
    check_export_import(case, zoo[case])


def _live_stn_blob(hw, seed):
    """A reference state dict of a StnDispNet with a live (non-identity)
    STN branch at size hw."""
    _, variables = jax_variables("StnDispNet-stn", hw=hw, seed=seed)
    return export_torch_state(variables["params"], {}, "StnDispNet")


def test_stn_branch_follows_jax_both_ways(zoo, capsys):
    # (1) a model without STN ignores a checkpoint's live branch and keeps
    # its identity; (2) at the reference's 384x1280 the live branch goes
    # in and comes out as it is; (3) at another size a live branch is
    # exported as the identity (the reference's fixed width) and a
    # reference-size branch is not imported; each as JAX does it
    big = (384, 1280)
    blob = _live_stn_blob(big, seed=3)
    assert blob["fc_loc.0.weight"].shape == (1280, 15360)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in blob.items()}

    plain = zoo["StnDispNet"]
    port = port_model("StnDispNet", plain)
    load_reference_state(port, tensors)
    ref_params, _ = import_torch_state(plain["params"], {}, blob, "StnDispNet")
    assert_state_equal(port.state_dict(), state_dict_from_jax(ref_params, {}, "StnDispNet"))
    assert float(port.fc_loc[6].weight.detach().abs().max()) == 0.0

    _, live = jax_variables("StnDispNet-stn", hw=big, seed=4)
    port = port_model("StnDispNet", live, image_shape=big, use_stn=True)
    load_reference_state(port, tensors)
    ref_params, _ = import_torch_state(live["params"], {}, blob, "StnDispNet")
    assert_state_equal(port.state_dict(), state_dict_from_jax(ref_params, {}, "StnDispNet"))
    assert_state_equal(reference_state(port), export_torch_state(ref_params, {}, "StnDispNet"))

    small = zoo["StnDispNet-stn"]
    port = port_model("StnDispNet", small, image_shape=HW, use_stn=True)
    capsys.readouterr()
    load_reference_state(port, tensors)
    ref_params, _ = import_torch_state(small["params"], {}, blob, "StnDispNet")
    ours, theirs = capsys.readouterr().out.splitlines()
    assert ours == theirs == ("warning: STN branch not imported "
                              "(resolution-fixed fc_loc flatten mismatch)")
    assert_state_equal(port.state_dict(), state_dict_from_jax(ref_params, {}, "StnDispNet"))
    exported = reference_state(port)
    assert_state_equal(exported, export_torch_state(ref_params, {}, "StnDispNet"))
    assert exported["fc_loc.0.weight"].shape == (1280, 15360)
    fresh = build_model("StnDispNet", device="cpu", use_stn=False)
    fresh.load_state_dict(exported)  # strict: the reference's own schema


# StnDispNet's conv biases that feed a GroupNorm of one channel a group:
# their gradient is 0 in exact arithmetic (the norm removes a per-channel
# shift)
GN_CANCELLED = ("localization.0.0.bias", "localization.0.3.bias", "upconv_4.0.bias")


def _assert_gradients_match(params, ref, rtol=1e-4):
    """Every parameter gradient of `params` (name -> Parameter) against the
    bridged JAX gradients `ref` at relative L2 rtol; the GroupNorm-cancelled
    biases below 1e-6 of their conv weight's gradient on both sides."""
    assert {k for k, p in params.items() if p.grad is not None} == set(ref)
    for key, want in ref.items():
        got, want = params[key].grad.numpy(), want.numpy()
        if key in GN_CANCELLED:
            scale = float(np.linalg.norm(ref[key[:-4] + "weight"].numpy()))
            assert max(np.linalg.norm(got), np.linalg.norm(want)) <= 1e-6 * scale, key
            continue
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= rtol, (key, rel)


@pytest.mark.parametrize("case", ["DispNetS", "StnDispNet"])
def test_parameter_gradients_match_jax(case, zoo):
    # d(Σ_s <c_s, out_s>)/d(parameters) in eval mode (DispNetS' BatchNorm on
    # its running statistics) vs jax.grad of the flax apply, with fixed
    # random c_s: every parameter at rel L2 <= 1e-4
    name, jax_kwargs, port_kwargs = CASES[case]
    variables = zoo[case]
    model = jax_build_model(name, **jax_kwargs)
    rng = np.random.default_rng(11)
    img = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    port = port_model(name, variables, image_shape=HW, **port_kwargs).eval()
    outputs = port(nchw(img))
    coeffs = [rng.normal(size=tuple(o.shape)).astype(np.float32) for o in outputs]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outputs, coeffs)).backward()

    def jax_loss(params):
        outs = model.apply({**variables, "params": params}, jnp.asarray(img), train=False)
        return sum(jnp.sum(jnp.moveaxis(o, -1, 1) * c) for o, c in zip(outs, coeffs))

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(jax_loss))(variables["params"]))
    _assert_gradients_match(dict(port.named_parameters()),
                            state_dict_from_jax(grads, None, name))


class _StnFront(flax_nn.Module):
    """StnDispNet's spatial transformer alone, under StnDispNet's flax
    parameter names (DownsampleConvGN_0-4, Dense_0-3): the input resampled
    through the predicted affine transform."""

    @flax_nn.compact
    def __call__(self, x):
        loc = x
        for width in (16, 32, 32, 32, 32):
            loc = jax_layers.DownsampleConvGN(width)(loc)
        loc = loc.reshape(loc.shape[0], -1)
        for features in (1280, 256, 128):
            loc = flax_nn.relu(flax_nn.Dense(features)(loc))
        theta = flax_nn.Dense(6)(loc).reshape(-1, 2, 3)
        grid = jax_stn.affine_grid(theta, x.shape[1], x.shape[2])
        return jax_resample.grid_sample(x, grid, align_corners=False)


def test_spatial_transformer_gradients_match_jax(zoo):
    # the transformer's own parameters (localization.*, fc_loc.*) through
    # affine_grid and grid_sample(align_corners=False): d<c, resampled
    # input>/d(parameters) vs jax.grad at rel L2 <= 1e-4. Through the whole
    # model the comparison is ill-conditioned at these random weights: the
    # two packages' sampling grids differ in the last bit, the resampled
    # images by that much times the image's slope, and the depth branch's
    # gradient is steep in its input (test_parameter_gradients_match_jax
    # holds that branch to JAX on one input)
    variables = zoo["StnDispNet-stn"]
    front = {k: v for k, v in variables["params"].items()
             if k.startswith("Dense_") or k in {f"DownsampleConvGN_{j}" for j in range(5)}}
    rng = np.random.default_rng(12)
    img = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    coeff = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    port = port_model("StnDispNet", variables, image_shape=HW, use_stn=True)
    x = nchw(img)
    theta = port.fc_loc(port.localization(x).flatten(1)).reshape(-1, 2, 3)
    out = grid_sample_port(x, affine_grid(theta, *HW), align_corners=False)
    (out * nchw(coeff)).sum().backward()
    grads = jax.jit(jax.grad(lambda p: jnp.sum(_StnFront().apply({"params": p},
                                                                 jnp.asarray(img)) * coeff)))(front)
    full = dict(variables["params"], **jax.tree.map(np.asarray, grads))
    ref = {k: v for k, v in state_dict_from_jax(full, None, "StnDispNet").items()
           if k.startswith(("localization.", "fc_loc."))}
    params = {k: p for k, p in port.named_parameters() if k in ref}
    _assert_gradients_match(params, ref)
