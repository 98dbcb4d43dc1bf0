"""Port parity for DispNetS, StnDispNet and DispResNet under the "spatial"
mesh, on bands that hold no row of a net's coarser levels among them.

JAX's mesh needs only H % spatial == 0: GSPMD partitions every model at
any such height. The port runs a depth net on a band of the image's rows
and applies the banded-level rule at each level
(parallel/spatial.banded_level): a level whose bands start on a multiple
of its stride runs on the bands, with halos that reach past a band
shorter than themselves; a level whose bands hold no whole row runs on
the map gathered from the bands (with its gradient), and the first finer
level that is banded again cuts its band back out. DispNetS (seven
levels, four scales) gathers its 64x and 128x levels at 64 rows over 2;
StnDispNet adds GroupNorm's per-image statistics over the bands, the
banded transposed conv and its STN (the 32x map gathered, theta on every
rank, the whole frame sampled at the band's grid rows); DispResNet-18
runs on JAX's equal bands of 16 rows (64 over 4) and, with all_scales,
on 32 / 32 / 32 / 8 rows of 104 (one row at scale 3).

Held here: the banded units against the whole input (the transposed
conv, GroupNorm, the halo past a one-row band, a BatchNorm on a gathered
level), each net's forward on bands against the whole (train and eval
mode; the parameter gradient of a linear functional of the outputs),
the eval step, and whole steps against the port's one-process step and
JAX's loss on the whole batch. The ranks are tests/torch_spatial_zoo_worker.py's,
spawned on the CPU by torch_parallel_worker.start_ranks; the one-process
results and JAX's losses are computed while they run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_worker as worker
from tests import torch_spatial_zoo_worker as zoo
from tests.test_torch_spatial import (
    JAX_LOSS_RTOL,
    STATS_RTOL,
    STEP_METRIC_RTOL,
    UNIT_RTOL,
    _flat,
    _rel_l2,
)
from tests.test_torch_spatial_uneven import (
    jax_nets,
    test_step_on_uneven_bands_matches_the_one_process_step as _one_process_check,
)
from tests.test_torch_zoo import jax_variables, random_variables
from unsupervised_pseuso_lidar_tpu.losses.total import total_loss as jax_total_loss
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.trainer import (
    forward_batch as jax_forward_batch,
    normalize_uint8_batch as jax_normalize_uint8_batch,
)
from unsupervised_pseuso_lidar_tpu_torch.losses.total import total_loss
from unsupervised_pseuso_lidar_tpu_torch.models import layers
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh
from unsupervised_pseuso_lidar_tpu_torch.train.trainer import bind_spatial
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
# the groups: (ranks, the forwards they run, the steps they take)
GROUPS = {2: (("dispnets", "stn", "stn_off"), ("dispnets", "stn")),
          4: (("dispnets", "resnet"), ("resnet_h64", "resnet_h104_all_scales"))}
FORWARD_CASES = [(s, name, train) for s, (names, _) in GROUPS.items() for name in names
                 for train in (False, True)]
PLACEMENT_CASES = [(s, name) for s, (names, _) in GROUPS.items() for name in names]
STEP_NAMES = [name for _, names in GROUPS.values() for name in names]
# StnDispNet's forward with its STN, the parameter gradient of a linear
# functional of its output: the whole image's own fp32 evaluation sits
# 2.8e-3 from an fp64 one (the bands' 2.5e-3; python -m
# tests.torch_spatial_zoo_fp64 stn), and the bands 7.3e-4 from it. Held
# at STN_GRAD_RTOL: the flat gradient, the STN's leaves (7.4e-4; the
# plain evaluation 2.7e-3 from fp64) and the depth net's (2.8e-4; 3.7e-3)
# each on their own; each STN leaf at STN_LEAF_RTOL (worst 2.7e-3; the
# plain evaluation's worst 4.0e-3 from fp64); the biases its first
# GroupNorm cancels at STN_CANCELLED_ATOL of the gradient's norm. Every
# other unit is held at UNIT_RTOL
STN_GRAD_RTOL = 1e-3
STN_LEAF_RTOL = 1e-2
STN_CANCELLED_ATOL = 1e-6
# StnDispNet's parameters: the STN's (the gradient through gather_band's
# backward and theta) and the depth net's, and the conv biases that the
# STN's first GroupNorm cancels (16 channels in 16 groups: their
# gradient is 0 but for rounding)
STN_PREFIXES = ("localization.", "fc_loc.")
STN_CANCELLED = ("localization.0.0.bias", "localization.0.3.bias")


def stn_parts(grads):
    """{part: its parameter names} of StnDispNet's gradients."""
    stn = [k for k in grads if k.startswith(STN_PREFIXES) and k not in STN_CANCELLED]
    return {"stn": stn, "stn_cancelled": list(STN_CANCELLED),
            "depth_net": [k for k in grads if not k.startswith(STN_PREFIXES)]}


def part_rel(grads, ref, keys):
    """rel L2 of the sub-vector of `keys`."""
    return _rel_l2(_flat({k: grads[k] for k in keys}), _flat({k: ref[k] for k in keys}))


def worst_leaf(grads, ref, keys):
    """(name, rel L2) of the leaf of `keys` farthest from ref."""
    return max(((k, round(_rel_l2(grads[k], ref[k]), 6)) for k in keys), key=lambda kv: kv[1])


# the JAX models of the weight keys (zoo.CASES / zoo.FORWARDS)
JAX_ZOO = {"dispnets": "DispNetS", "stn": "StnDispNet-stn", "stn_off": "StnDispNet"}


def _weights():
    """{key: (flax model, numpy variables)}: DispResNet-18 and PoseNet of
    tests/test_torch_spatial_uneven, DispNetS, StnDispNet with and without
    its STN at 64 x 96 (tests/test_torch_zoo.jax_variables), and a PoseNet
    with tests/test_torch_zoo_train's smaller head bias (rotation 0.002
    rad, translation 0.005 a frame), all seeded."""
    nets = {k: v for k, v in jax_nets().items() if k in ("depth", "pose")}
    for key, case in JAX_ZOO.items():
        nets[key] = jax_variables(case, hw=(64, 96))
    pose = jax_build_model("PoseNet", s2d_convs=0)
    img = jnp.zeros((1, 64, 96, 3), jnp.float32)
    variables = random_variables(pose, img, [img, img], seed=3)
    head = variables["params"]["TorchConv_7"]["Conv_0"]
    head["bias"] = (np.random.default_rng(7).normal(size=(2, 6))
                    * np.array([0.002] * 3 + [0.005] * 3) / 0.06).reshape(-1).astype(np.float32)
    nets["pose_near"] = (pose, variables)
    return nets


def _port_name(key):
    return {"depth": "DispResNet", "dispnets": "DispNetS"}.get(
        key, "PoseNet" if key.startswith("pose") else "StnDispNet")


def _port_weights(nets):
    return {key: state_dict_from_jax(variables["params"], variables.get("batch_stats", {}),
                                     _port_name(key))
            for key, (_, variables) in nets.items()}


def _unit_inputs():
    """The units' seeded inputs, cotangents and layer states."""
    gen = torch.Generator().manual_seed(12)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    inputs = {}
    for name, (net, kwargs, _, height, width) in zoo.FORWARDS.items():
        scales = 4 if net == "DispNetS" else 1
        inputs[name] = (torch.rand(2, 3, height, width, generator=gen),
                        [rand(2, 1, height >> s, width >> s) for s in range(scales)])
    transposed = []
    for height, level in zoo.TRANSPOSED:
        rows = -(-height // 2 ** level)
        layer = layers.conv_transpose(6, 4)
        layers.torch_default_init_(layer, gen)
        transposed.append((rand(2, 6, rows, 5), rand(2, 4, 2 * rows, 10), layer.state_dict()))
    inputs["transposed"] = transposed
    norm = layers.group_norm(32)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=gen)
        norm.bias.normal_(0.0, 0.1, generator=gen)
    # an offset makes E[x²] − E[x]² cancel: the fp64 sums must hold it
    inputs["group_norm"] = (rand(2, 32, 96, 7) * 0.5 + 3.0, rand(2, 32, 96, 7),
                            norm.state_dict())
    whole = sum(zoo.HALO_ROWS)
    above, below = zoo.HALO_REACH
    cotangents = []
    for j, rows in enumerate(zoo.HALO_ROWS):
        start = sum(zoo.HALO_ROWS[:j])
        out_rows = min(start + rows + below, whole) - max(start - above, 0)
        cotangents.append(rand(2, 3, out_rows, 4))
    inputs["halo"] = (rand(2, 3, whole, 4), cotangents)
    bn = layers.BatchNorm2d(8, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
    inputs["batch_norm"] = (rand(4, 8, 64, 6) + 1.0, rand(4, 8, 64, 6), bn.state_dict())
    return inputs


def jax_loss(nets, name):
    """JAX's loss of case `name`'s step on its whole batch (forward only):
    normalize, forward_batch in train mode, total_loss ('min', the
    steps' settings)."""
    key = zoo.CASES[name][2]
    depth, variables = nets[key]
    if key == "depth":  # the weights' heads are those of every scale set
        depth = jax_build_model("DispResNet", **zoo.CASES[name][1])
    pose, pose_variables = nets[zoo.POSE_KEY.get(name, "pose")]
    params = {"depth": variables["params"], "pose": pose_variables["params"]}
    stats = {"depth": variables.get("batch_stats", {}), "pose": {}}

    def loss(params, stats, batch):
        batch = jax_normalize_uint8_batch(batch)
        disps_tgt, disps_ref0, poses, _ = jax_forward_batch(depth, pose, params, stats,
                                                            batch, train=True)
        reproj, smooth = jax_total_loss(
            batch["tgt"], [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]],
            [disps_tgt, disps_ref0], poses, batch["intrinsics"], mode="min",
            warp_impl="gather", **worker.STEP_SETTINGS)
        return reproj + smooth

    batch = zoo.step_batch(name)
    return float(jax.jit(loss)(params, stats, {k: jnp.asarray(batch[k])
                                               for k in ("tgt", "ref_imgs", "intrinsics")}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {spatial: every rank's results}, "ref": the one-process
    units, forwards and steps, "one_rank": the forwards' gradients and the
    steps under a one-rank data mesh, "jax": JAX's losses, "inputs"}."""
    nets = _weights()
    weights = _port_weights(nets)
    inputs = _unit_inputs()
    tmp = tmp_path_factory.mktemp("spatial_zoo")
    waits = {s: worker.start_ranks(zoo.ranks, s, tmp, weights, inputs, forwards, names,
                                   spatial=s)
             for s, (forwards, names) in GROUPS.items()}
    wait_one = worker.start_ranks(zoo.one_rank, 1, tmp, weights, inputs, STEP_NAMES)
    ref = {"units": {"transposed": zoo.transposed(None, inputs),
                     "group_norm": zoo.group_norm(None, inputs),
                     "batch_norm": zoo.gathered_batch_norm(None, inputs)},
           "forward": {(name, train): zoo.forward(None, weights, name, inputs, train)
                       for name in zoo.FORWARDS for train in (False, True)},
           "steps": {name: zoo.one_step(weights, name) for name in STEP_NAMES},
           "eval": {name: zoo.eval_metrics(weights, name) for name in STEP_NAMES}}
    losses = {name: jax_loss(nets, name) for name in STEP_NAMES}
    ranks = {s: wait() for s, wait in waits.items()}
    return {"ranks": ranks, "ref": ref, "one_rank": wait_one()[0], "jax": losses,
            "inputs": inputs}


def _summed(parts):
    """The ranks' parameter (or weight) gradients of one linear
    functional, summed: every rank's loss is its band's part of the
    whole's."""
    if isinstance(parts[0], dict):
        return {k: sum(p[k] for p in parts) for k in parts[0]}
    return sum(parts)


@pytest.mark.parametrize("case", range(len(zoo.TRANSPOSED)))
def test_transposed_conv_on_bands_matches_the_whole(runs, case):
    # layers.ConvTranspose2d (k 3, stride 2, padding 1, output_padding 1)
    # on bands 32 / 32, 64 / 32 and 32 / 3 (an odd last band) takes one
    # row of the band below, a zero row at the image's bottom: the bands'
    # outputs, concatenated, and the input gradient are the whole map's,
    # the weight and bias gradients the ranks' sum, at rel L2 UNIT_RTOL
    parts = [r["units"]["transposed"][case] for r in runs["ranks"][2]]
    ref = runs["ref"]["units"]["transposed"][case]
    for i, got in ((0, torch.cat([p[0] for p in parts], 2)),
                   (1, torch.cat([p[1] for p in parts], 2)),
                   (2, _summed([p[2] for p in parts])), (3, _summed([p[3] for p in parts]))):
        assert got.shape == ref[i].shape, (i, got.shape, ref[i].shape)
        assert _rel_l2(got, ref[i]) <= UNIT_RTOL, (i, _rel_l2(got, ref[i]))


def test_group_norm_on_bands_matches_the_whole(runs):
    # layers.GroupNorm on bands 64 / 32 of 96 rows: each image's group
    # statistics are the fp64 sums over the data row, so the values, the
    # input gradient and the summed weight and bias gradients are
    # nn.GroupNorm's on the whole map at rel L2 UNIT_RTOL
    parts = [r["units"]["group_norm"] for r in runs["ranks"][2]]
    ref = runs["ref"]["units"]["group_norm"]
    rels = [_rel_l2(torch.cat([p[0] for p in parts], 2), ref[0]),
            _rel_l2(torch.cat([p[1] for p in parts], 2), ref[1]),
            _rel_l2(_summed([p[2] for p in parts]), ref[2]),
            _rel_l2(_summed([p[3] for p in parts]), ref[3])]
    print(f"GroupNorm on bands: rel L2 {rels}")
    assert max(rels) <= UNIT_RTOL, rels


def test_halo_reaches_past_a_one_row_band(runs):
    # bands of 3, 1, 1 and 2 rows, 2 halo rows above and 3 below: every
    # band gets the image's rows around it from as many bands as hold
    # them (band 0's rows below come from bands 1-3), fewer at the image's
    # border, bit for bit; each row's gradient is its own cotangent plus
    # those of the halos that carried it
    x, cotangents = runs["inputs"]["halo"]
    leaf = x.clone().requires_grad_()
    above, below = zoo.HALO_REACH
    total = 0.0
    for j, (got, _) in enumerate(r["units"]["halo"] for r in runs["ranks"][4]):
        start = sum(zoo.HALO_ROWS[:j])
        want = leaf[:, :, max(start - above, 0):start + zoo.HALO_ROWS[j] + below]
        assert torch.equal(got, want.detach()), j
        total = total + (want * cotangents[j]).sum()
    total.backward()
    grad = torch.cat([r["units"]["halo"][1] for r in runs["ranks"][4]], 2)
    assert _rel_l2(grad, leaf.grad) <= UNIT_RTOL


def test_batch_norm_on_a_gathered_level_matches_the_whole_map(runs):
    # a band gathered with its gradient, a train-mode BatchNorm over the
    # mesh on the whole map (its statistics sum both ranks' identical
    # copies: the mean and variance are the map's, and nothing is divided
    # by spatial), the band cut back out: the running statistics, the
    # bands' input gradients concatenated and the summed weight and bias
    # gradients are the whole map's at rel L2 UNIT_RTOL (the gather's
    # backward adds the copies' cotangents)
    parts = [r["units"]["batch_norm"] for r in runs["ranks"][2]]
    ref = runs["ref"]["units"]["batch_norm"]
    rels = [_rel_l2(torch.cat([p[0] for p in parts], 2), ref[0]),
            _rel_l2(parts[0][1], ref[1]), _rel_l2(parts[0][2], ref[2]),
            _rel_l2(_summed([p[3] for p in parts]), ref[3]),
            _rel_l2(_summed([p[4] for p in parts]), ref[4])]
    assert all(torch.equal(p[1], parts[0][1]) and torch.equal(p[2], parts[0][2])
               for p in parts)
    assert max(rels) <= UNIT_RTOL, rels


@pytest.mark.parametrize("spatial,name,train", FORWARD_CASES)
def test_forward_on_bands_matches_the_whole(runs, spatial, name, train):
    # the net on each rank's band (32 / 32 over 2, 16 each over 4) in
    # eval or train mode (BatchNorm's global statistics, GroupNorm's over
    # the data row): each output scale's bands concatenated are the whole
    # forward's at rel L2 UNIT_RTOL. In train mode the parameter gradients
    # of Σ output · cotangent, summed over the ranks, are those of the
    # whole image under a one-rank data mesh, whose BatchNorm sums as the
    # bands' does (layers._GlobalBatchNorm), at UNIT_RTOL; F.batch_norm's
    # fp32 backward on the CPU is another rounding: DispResNet-18's
    # gradient of this functional sits 2.0e-4 from an fp64 evaluation
    # through it, 2.8e-6 through the mesh's BatchNorm (python -m
    # tests.torch_spatial_zoo_fp64 resnet). With the STN the gradient is
    # held at STN_GRAD_RTOL
    parts = [r["units"]["forward"][(name, train)] for r in runs["ranks"][spatial]]
    ref_outs = runs["ref"]["forward"][(name, train)][0]
    for scale, ref in enumerate(ref_outs):
        got = torch.cat([p[0][scale] for p in parts], 2)
        assert got.shape == ref.shape, (scale, got.shape, ref.shape)
        assert _rel_l2(got, ref) <= UNIT_RTOL, (scale, _rel_l2(got, ref))
    if train:
        ref_grads = runs["one_rank"]["forward"][name][1]
        grads = _summed([p[1] for p in parts])
        assert sorted(grads) == sorted(ref_grads)
        rel = _rel_l2(_flat(grads), _flat(ref_grads))
        plain = _rel_l2(_flat(grads), _flat(runs["ref"]["forward"][(name, train)][1]))
        print(f"{name} over {spatial}: parameter gradient rel L2 {rel:.3g} "
              f"({plain:.3g} from the plain one-process forward)")
        assert rel <= (STN_GRAD_RTOL if name == "stn" else UNIT_RTOL), rel
        if name == "stn":
            # the STN's leaves and the depth net's, each on its own: the
            # STN holds 99 % of the flat norm, and its gradient alone
            # passes through gather_band's backward and theta
            parts = stn_parts(ref_grads)
            stn, depth_net = (part_rel(grads, ref_grads, parts[k]) for k in ("stn", "depth_net"))
            leaf = worst_leaf(grads, ref_grads, parts["stn"])
            cancelled = max(float(grads[k].norm()) for k in STN_CANCELLED) / float(
                _flat(ref_grads).norm())
            print(f"  STN leaves rel L2 {stn:.3g}, worst {leaf}; depth net {depth_net:.3g}; "
                  f"GroupNorm-cancelled biases {cancelled:.3g} of the gradient's norm")
            assert stn <= STN_GRAD_RTOL and depth_net <= STN_GRAD_RTOL, (stn, depth_net)
            assert leaf[1] <= STN_LEAF_RTOL, leaf
            assert cancelled <= STN_CANCELLED_ATOL, cancelled


@pytest.mark.parametrize("what", ["conv without a level", "conv without a height",
                                  "net without a height", "net on another band"])
def test_a_banded_module_needs_its_level_and_the_image_height(what):
    # under a spatial mesh a banded module whose level or image height is
    # not set raises (nothing is taken as banded by default), and a depth
    # net's forward raises without the image's height or on rows that are
    # not this rank's band of it; all before any exchange
    mesh = Mesh(None, 0, 2, torch.device("cpu"), spatial=2)
    x = torch.zeros(1, 3, 32, 8)
    if what.startswith("conv"):
        module = layers.conv(3, 4, 3, level=None if what.endswith("level") else 0)
        module.mesh = mesh
        if what.endswith("level"):
            module.height = 64
        with pytest.raises(ValueError, match="needs its level"):
            module(x)
        return
    model = build_model("DispResNet", device="cpu")
    bind_spatial([model], mesh)
    with pytest.raises(ValueError, match="needs the image's height" if what.endswith(
            "height") else "was expected"):
        model(x) if what.endswith("height") else model(x, height=96)


def assert_declared_placement(placements):
    """Every rank's placement of one forward's outputs
    (torch_parallel_worker.placement): each rank declares the same
    (layers.Banded.banded_outputs), an output declared a band holds this
    rank's band's rows, one declared whole the same rows on every rank
    and at least the whole map's. -> the declaration."""
    declared, first_rows = placements[0][:2]
    assert len(declared) == len(first_rows)
    for got, rows, band_rows, whole_rows in placements:
        assert got == declared
        for i, on_band in enumerate(declared):
            if on_band:
                assert rows[i] == band_rows[i] < whole_rows[i], (i, rows, band_rows)
            else:
                assert rows[i] == first_rows[i] >= whole_rows[i], (i, rows, whole_rows)
    return declared


@pytest.mark.parametrize("spatial,name", PLACEMENT_CASES)
def test_declared_placement_is_what_the_forward_returns(runs, spatial, name):
    # DispNetS (four scales) over 2 and 4 ranks, StnDispNet with and
    # without its STN at 64 rows (a multiple of 16) over 2, DispResNet-18
    # over 4: every output is declared this rank's band, and each rank's
    # output holds the band's rows
    placements = [r["units"]["forward"][(name, False)][2] for r in runs["ranks"][spatial]]
    assert all(assert_declared_placement(placements))


@pytest.mark.parametrize("declared", [True, False], ids=["band", "whole"])
def test_a_map_that_contradicts_its_declared_placement_raises(declared):
    # total_loss holds each disparity to its net's declaration before any
    # exchange: the whole 64-row map declared a band, and the band's 32
    # rows declared whole, raise, naming the band's rows
    mesh = Mesh(None, 0, 2, torch.device("cpu"), spatial=2)
    frames = torch.rand(1, 3, 64, 8)
    disp = torch.rand(1, 1, 64 if declared else 32, 8)
    with pytest.raises(ValueError, match="band of it is rows 0:32 of a 64-row map"):
        total_loss(frames, [frames, frames], [[disp], [disp]], torch.zeros(1, 2, 6),
                   torch.eye(3), mesh=mesh, banded=(declared,))


def _step_ranks(runs, name):
    spatial = next(s for s, (_, names) in GROUPS.items() if name in names)
    return [r["steps"][name] for r in runs["ranks"][spatial]]


@pytest.mark.parametrize("name", STEP_NAMES)
def test_step_on_bands_matches_the_one_process_step(runs, name):
    # every rank returns the same metrics and gradients (bit for bit);
    # the metrics at rel 1e-5, the gradient at rel L2 <= 1e-4 and the
    # BatchNorm running statistics at 1e-5 (test_torch_spatial_uneven's
    # check) against the port's step on the whole batch under a one-rank
    # data mesh, whose BatchNorm sums as the bands' does; against the
    # plain one-process step (F.batch_norm) the metrics at rel 1e-5 and
    # the statistics at 1e-5. The plain step's gradient is another
    # rounding of these chaotic steps (tests/test_torch_zoo_train's
    # docstring; test_torch_spatial_scales holds DispResNet-50 so): it is
    # printed beside
    ranks = _step_ranks(runs, name)
    _one_process_check({"ranks": {name: ranks}, "ref": runs["one_rank"]["steps"]}, name)
    plain = runs["ref"]["steps"][name]
    for key, value in plain["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][key], value, rtol=STEP_METRIC_RTOL,
                                   err_msg=key)
    for key, value in plain["stats"].items():
        np.testing.assert_allclose(ranks[0]["stats"][key].numpy(), value.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_RTOL, err_msg=key)
    print(f"{name} vs the plain step: gradient rel L2 "
          f"{_rel_l2(_flat(ranks[0]['grads']), _flat(plain['grads'])):.3g} (bands), "
          f"{_rel_l2(_flat(runs['one_rank']['steps'][name]['grads']), _flat(plain['grads'])):.3g}"
          " (one-rank mesh)")


@pytest.mark.parametrize("name", STEP_NAMES)
def test_eval_step_on_bands_matches_the_one_process_eval_step(runs, name):
    # the eval step ('min' loss on the bands, the Eigen depth metrics on
    # the depth gathered from them, pose metrics) with the net in eval
    # mode: every rank's metrics and whole depth are alike, and they are
    # the one-process step's at rel 1e-5
    spatial = next(s for s, (_, names) in GROUPS.items() if name in names)
    ranks = [r["eval"][name] for r in runs["ranks"][spatial]]
    metrics, depth = runs["ref"]["eval"][name]
    assert all(r[0] == ranks[0][0] and torch.equal(r[1], ranks[0][1]) for r in ranks)
    assert sorted(ranks[0][0]) == sorted(metrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(ranks[0][0][key], value, rtol=STEP_METRIC_RTOL,
                                   atol=1e-7, err_msg=key)
    assert _rel_l2(ranks[0][1], depth) <= UNIT_RTOL


@pytest.mark.parametrize("name", STEP_NAMES)
def test_step_on_bands_matches_the_jax_loss(runs, name):
    # the ranks' loss vs JAX's loss of the step on the whole batch on one
    # device (JAX's own sharded-vs-single-device tolerance)
    np.testing.assert_allclose(_step_ranks(runs, name)[0]["metrics"]["loss"],
                               runs["jax"][name], rtol=JAX_LOSS_RTOL)
