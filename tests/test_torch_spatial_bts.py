"""Port parity for BtsModel under the "spatial" mesh, and for the
non-integer resamples of a band.

JAX's mesh needs only H % spatial == 0 (and BtsModel a height that is a
multiple of 32, below which JAX's model cannot concatenate its skips).
The port runs BtsModel on a band of the image's rows: its DenseNet-161
encoder's convs, max-pool and 2x2 average pools, its decoder's convs and
its ASPP's 3x3 convs dilated up to 24 rows at 1/8 — whose halos reach
past bands shorter than that — each at its level, the levels whose bands
hold no whole row on the gathered map, LPG on the band's coarse cells.
A coarse map whose upsample to the image is no integer factor (all_scales
and DispNetS at a height that is no multiple of 8, StnDispNet's 16·⌈H/16⌉
rows) is gathered, resized whole and its band cut back out.

Held here, on gloo ranks spawned on the CPU by
torch_parallel_worker.start_ranks (tests/torch_spatial_bts_worker.py):
the dilated conv and the average pool on bands against the whole map,
the resize-and-cut against the whole resize, StnDispNet with its STN at
72 rows against the whole map, and two training steps of
BtsModel (num_features 128, the narrowest with every reduction cascade) +
PoseNet at 64x96 over 2 ranks (bands of 32) and 4 (bands of 16; the 1/32
level gathered), and one step of each non-integer-resample class over 2,
each against the same steps under a one-rank data mesh (the whole image,
its BatchNorm summed as the bands' is: F.batch_norm's CPU backward is
another rounding, ROADMAP.md §3), the plain one-process step beside: the
loss at SPATIAL_LOSS_RTOL, the gradient at STEP_GRAD_REL_L2, the
BatchNorm running statistics at SPATIAL_STATS_RTOL.
"""

import pytest
import torch
import torch.nn.functional as F

from tests import torch_parallel_worker as worker
from tests import torch_spatial_bts_worker as bts
from tests.test_torch_spatial import STEP_GRAD_REL_L2, UNIT_RTOL, _flat, _rel_l2
from unsupervised_pseuso_lidar_tpu_torch.models.registry import build_model
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear

torch.set_num_threads(1)
# the banded step against the step under a one-rank data mesh: the loss
# (rel) and the BatchNorm running statistics (rel and abs)
SPATIAL_LOSS_RTOL = 1e-6
SPATIAL_STATS_RTOL = 1e-6
STEP_CASES = [(s, name) for s, names in bts.GROUPS.items() for name in names]


def _unit_inputs():
    """The units' seeded inputs, cotangents and conv weights."""
    gen = torch.Generator().manual_seed(17)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    inputs = {"dilated": [], "pooled": [], "resized": []}
    for d, height in bts.DILATED:
        weight = rand(4, 6, 3, 3) * 0.2
        inputs["dilated"].append((rand(2, 6, height, 5), rand(2, 4, height, 5),
                                  {"weight": weight}))
    for height, level in bts.POOLED:
        rows = -(-height // 2 ** level)
        inputs["pooled"].append((rand(2, 3, rows, 6), rand(2, 3, rows // 2, 3)))
    for height, scale in bts.RESIZED:
        inputs["resized"].append((rand(2, 1, -(-height // 2 ** scale), 5).abs() + 1.0,
                                  rand(2, height, 40)))
    # StnDispNet with its STN, its transform moved off the identity (a
    # sample on a pixel is where the bilinear gradient jumps) and down by
    # ~2 rows, so that rows of the 8-row band sample the 64-row one
    net = build_model("StnDispNet", gen, "cpu", use_stn=True, image_shape=bts.STN_SHAPE)
    state = net.state_dict()
    last = f"fc_loc.{len(net.fc_loc) - 1}.bias"
    state[last] = state[last] + torch.tensor([0.03, 0.02, 0.01, -0.02, 0.04, 0.05])
    height, width = bts.STN_SHAPE
    rows = 16 * -(-height // 16)
    inputs["stn"] = (rand(2, 3, height, width), rand(2, 1, rows, width), state)
    return inputs


def _whole_units(inputs):
    """The units on the whole maps: (output, d input[, d weight]) of Σ
    output · cotangent."""
    out = {"dilated": [], "pooled": [], "resized": []}
    for (d, _), (x, g, state) in zip(bts.DILATED, inputs["dilated"]):
        leaf, weight = x.clone().requires_grad_(), state["weight"].clone().requires_grad_()
        y = F.conv2d(leaf, weight, padding=d, dilation=d)
        (y * g).sum().backward()
        out["dilated"].append((y.detach(), leaf.grad, weight.grad))
    for x, g in inputs["pooled"]:
        leaf = x.clone().requires_grad_()
        y = F.avg_pool2d(leaf, 2, 2)
        (y * g).sum().backward()
        out["pooled"].append((y.detach(), leaf.grad))
    for x, g in inputs["resized"]:
        leaf = x.clone().requires_grad_()
        y = resize_bilinear(leaf, g.shape[1], g.shape[2])[:, 0]
        (y * g).sum().backward()
        out["resized"].append((y.detach(), leaf.grad))
    out["stn"] = bts.stn(None, inputs)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {spatial: every rank's results}, "one_rank": the steps
    under a one-rank data mesh, "plain": the one-process steps, "whole":
    the units on whole maps, "inputs"}."""
    weights = bts.weights()
    inputs = _unit_inputs()
    tmp = tmp_path_factory.mktemp("spatial_bts")
    plain = {name: bts.train(weights, name) for name in bts.CASES}
    starts = {name: [result.pop("start") for result in steps] for name, steps in plain.items()}
    waits = {s: worker.start_ranks(bts.ranks, s, tmp, weights, inputs, names, starts,
                                   spatial=s)
             for s, names in bts.GROUPS.items()}
    wait_one = worker.start_ranks(bts.one_rank, 1, tmp, weights, starts)
    ranks = {s: wait() for s, wait in waits.items()}
    return {"ranks": ranks, "one_rank": wait_one()[0], "plain": plain,
            "whole": _whole_units(inputs), "inputs": inputs}


@pytest.mark.parametrize("case", range(len(bts.DILATED)))
def test_dilated_conv_on_bands_matches_the_whole(runs, case):
    # a 3x3 conv dilated by d (padding d) on bands of 10 or 16 rows of 40
    # or 64 over 4 ranks: each band takes d rows above and below, from
    # as many bands as hold them (d = 24 reaches past two or three), zero
    # rows at the image's border. The bands' outputs and input gradients,
    # concatenated, and the summed weight gradient are the whole map's at
    # rel L2 UNIT_RTOL
    parts = [r["units"]["dilated"][case] for r in runs["ranks"][4]]
    ref = runs["whole"]["dilated"][case]
    got = (torch.cat([p[0] for p in parts], 2), torch.cat([p[1] for p in parts], 2),
           sum(p[2] for p in parts))
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert _rel_l2(a, b) <= UNIT_RTOL, (i, _rel_l2(a, b))


@pytest.mark.parametrize("case", range(len(bts.POOLED)))
def test_average_pool_on_bands_matches_the_whole(runs, case):
    # the 2x2 average pool of DenseNet's transitions on a band (which
    # starts at an even row: no halo) or, where its output level is not
    # banded, on the map gathered from the bands (every rank's copy, each
    # rank's cotangent 1/s of the whole's: the gather's backward adds
    # them): the output and the input gradient are the whole map's
    height, level = bts.POOLED[case]
    parts = [r["units"]["pooled"][case] for r in runs["ranks"][4]]
    ref = runs["whole"]["pooled"][case]
    banded_out = parts[0][0].shape[2] < ref[0].shape[2]
    out = torch.cat([p[0] for p in parts], 2) if banded_out else parts[0][0]
    assert banded_out == (level == 0), (height, level)
    grad = torch.cat([p[1] for p in parts], 2)
    assert out.shape == ref[0].shape and grad.shape == ref[1].shape
    assert _rel_l2(out, ref[0]) <= UNIT_RTOL
    assert _rel_l2(grad, ref[1]) <= UNIT_RTOL


@pytest.mark.parametrize("case", range(len(bts.RESIZED)))
def test_non_integer_resize_of_a_band_matches_the_whole(runs, case):
    # a coarse band whose upsample to the image's rows is no integer
    # factor (13 rows of 1/8 to 100, 9 to 72) is gathered with its
    # gradient, resized whole and this rank's rows cut out: the bands'
    # rows and the bands' input gradients, concatenated, are the whole
    # resize's at rel L2 UNIT_RTOL
    parts = [r["units"]["resized"][case] for r in runs["ranks"][2]]
    ref = runs["whole"]["resized"][case]
    for i in range(2):
        got = torch.cat([p[i] for p in parts], 1 if i == 0 else 2)
        assert got.shape == ref[i].shape, (i, got.shape, ref[i].shape)
        assert _rel_l2(got, ref[i]) <= UNIT_RTOL, (i, _rel_l2(got, ref[i]))


def test_stn_on_bands_matches_the_whole(runs):
    # StnDispNet with its STN at 72 rows over 2 ranks (bands 64 / 8; no
    # multiple of 16): the localization's 32x map and the frame gathered,
    # each band's rows of the whole grid sampling the whole frame, and the
    # decoder's 80 rows gathered from the bands. Every rank's output is
    # the whole map's, and the bands' input gradients, concatenated, the
    # whole's, at rel L2 UNIT_RTOL
    parts = [r["units"]["stn"] for r in runs["ranks"][2]]
    ref = runs["whole"]["stn"]
    for out, _ in parts:
        assert out.shape == ref[0].shape, (out.shape, ref[0].shape)
        assert _rel_l2(out, ref[0]) <= UNIT_RTOL, _rel_l2(out, ref[0])
    grad = torch.cat([p[1] for p in parts], 2)
    assert grad.shape == ref[1].shape
    assert _rel_l2(grad, ref[1]) <= UNIT_RTOL, _rel_l2(grad, ref[1])


@pytest.mark.parametrize("spatial,name", STEP_CASES)
def test_step_on_bands_matches_the_one_rank_step(runs, spatial, name):
    # every rank returns the same metrics and gradients (bit for bit);
    # each step's loss at SPATIAL_LOSS_RTOL, gradient at rel L2
    # STEP_GRAD_REL_L2 and BatchNorm running statistics at
    # SPATIAL_STATS_RTOL against the step under a one-rank data mesh, whose
    # BatchNorm sums as the bands' does; the plain one-process step's
    # loss at SPATIAL_LOSS_RTOL too, its gradient printed beside
    ranks = [r["steps"][name] for r in runs["ranks"][spatial]]
    for i, ref in enumerate(runs["one_rank"][name]):
        got = ranks[0][i]
        for other in ranks[1:]:
            assert other[i]["metrics"] == got["metrics"]
            assert other[i]["grads"] == bts.digest(got["grads"])
        plain = runs["plain"][name][i]
        assert sorted(got["grads"]) == sorted(ref["grads"])
        rel = _rel_l2(_flat(got["grads"]), _flat(ref["grads"]))
        plain_rel = _rel_l2(_flat(got["grads"]), _flat(plain["grads"]))
        losses = [abs(got["metrics"]["loss"] / r["metrics"]["loss"] - 1) for r in (ref, plain)]
        stats = max((float(((got["stats"][k] - v).abs() / (v.abs() + 1.0)).max())
                     for k, v in ref["stats"].items()), default=0.0)
        print(f"{name} over {spatial}, step {i}: loss rel {losses[0]:.3g} (plain "
              f"{losses[1]:.3g}), gradient rel L2 {rel:.3g} (plain {plain_rel:.3g}), "
              f"statistics {stats:.3g}")
        assert max(losses) <= SPATIAL_LOSS_RTOL, losses
        assert rel <= STEP_GRAD_REL_L2, rel
        assert stats <= SPATIAL_STATS_RTOL, stats
