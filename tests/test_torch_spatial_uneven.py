"""Port parity for the "spatial" mesh at heights that do not split into
equal bands of 32-row multiples, and for action.remat.

JAX's mesh needs only H % spatial == 0: GSPMD pads the deeper levels.
The port cuts bands whose inner edges fall on multiples of 32 rows
(parallel/mesh.row_bands), so that every level of DispResNet keeps an
integer band edge; only the last band may end off the grain. Each rank's
loss terms are spatial × its band's share of the image's (weighted by its
real rows), so the mean over the ranks is the image's loss. Whole steps
at 96 rows over 2 ranks (64 / 32), 80 rows (64 / 16, depth_norm on) and
160 rows over 4 (64 / 32 / 32 / 32), and with remat (the loss under
torch.utils.checkpoint), against the port's one-process step and JAX's
loss on the whole batch; what check_height refuses (the bands
themselves: test_torch_spatial's placement test).

The ranks are gloo process groups spawned on the CPU
(tests/torch_spatial_uneven_worker.py via
torch_parallel_worker.start_ranks, one thread each); the one-process
steps and JAX's losses are computed while they run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_worker as worker
from tests import torch_spatial_uneven_worker as uneven
from tests.test_torch_spatial import (
    JAX_LOSS_RTOL,
    STATS_RTOL,
    STEP_GRAD_REL_L2,
    STEP_METRIC_RTOL,
    _flat,
    _rel_l2,
)
from tests.test_torch_zoo import random_variables
from tests.torch_spatial_worker import digest
from unsupervised_pseuso_lidar_tpu.losses.total import total_loss as jax_total_loss
from unsupervised_pseuso_lidar_tpu.models import build_model as jax_build_model
from unsupervised_pseuso_lidar_tpu.train.trainer import (
    forward_batch as jax_forward_batch,
    normalize_uint8_batch as jax_normalize_uint8_batch,
)
from unsupervised_pseuso_lidar_tpu_torch.parallel.mesh import Mesh
from unsupervised_pseuso_lidar_tpu_torch.parallel.spatial import check_height
from unsupervised_pseuso_lidar_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
NAMES = ("h96", "h80_depth_norm", "h160", "remat")


def jax_nets():
    """{key: (flax model, numpy variables)} of DispResNet-18 (all scales:
    its heads are those of the one-scale net too), DispResNet-50 with all
    scales and PoseNet(s2d_convs=0), seeded (test_torch_zoo.random_variables);
    PoseNet's head gets test_torch_train's bias (poses of a few pixels: at
    the identity warp every sample lies on a pixel, where the bilinear
    gradient jumps)."""
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    nets = {}
    for key, kwargs in (("depth", {"all_scales": True}),
                        ("depth50", {"num_layers": 50, "all_scales": True})):
        model = jax_build_model("DispResNet", **kwargs)
        nets[key] = (model, random_variables(model, img, seed=2, train=False))
    pose = jax_build_model("PoseNet", s2d_convs=0)
    variables = random_variables(pose, img, [img, img], seed=3)
    rng = np.random.default_rng(5)
    head = variables["params"]["TorchConv_7"]["Conv_0"]
    head["bias"] = (rng.normal(size=(2, 6)) * np.array([0.005] * 3 + [0.03] * 3)
                    / 0.06).reshape(-1).astype(np.float32)
    nets["pose"] = (pose, variables)
    return nets


def port_weights(nets):
    """The state dicts the ranks load: {"depth", "depth50", "pose"}."""
    return {key: state_dict_from_jax(variables["params"], variables.get("batch_stats", {}),
                                     "PoseNet" if key == "pose" else "DispResNet")
            for key, (_, variables) in nets.items()}


def jax_loss(nets, name):
    """JAX's loss of case `name`'s step on its whole batch: the step
    body's loss_fn (normalize, forward_batch in train mode, total_loss),
    forward only."""
    height, width, _, depth_kwargs, settings = uneven.CASES[name]
    depth = jax_build_model("DispResNet", **depth_kwargs)
    variables = nets[uneven.depth_key(name)][1]
    pose, pose_variables = nets["pose"]
    params = {"depth": variables["params"], "pose": pose_variables["params"]}
    stats = {"depth": variables["batch_stats"], "pose": {}}
    loss_settings = {**worker.STEP_SETTINGS, **{k: v for k, v in settings.items()
                                                if k != "remat"}}

    def loss(params, stats, batch):
        batch = jax_normalize_uint8_batch(batch)
        disps_tgt, disps_ref0, poses, _ = jax_forward_batch(depth, pose, params, stats,
                                                            batch, train=True)
        reproj, smooth = jax_total_loss(
            batch["tgt"], [batch["ref_imgs"][:, 0], batch["ref_imgs"][:, 1]],
            [disps_tgt, disps_ref0], poses, batch["intrinsics"], mode="min",
            warp_impl="gather", **loss_settings)
        return reproj + smooth

    batch = uneven.step_batch(name)
    return float(jax.jit(loss)(params, stats, {k: jnp.asarray(batch[k])
                                               for k in ("tgt", "ref_imgs", "intrinsics")}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {spatial: every rank's results}, "ref": the one-process
    steps, "one_process_remat": the 'remat' case's step in one process,
    "jax": JAX's losses}."""
    nets = jax_nets()
    weights = port_weights(nets)
    tmp = tmp_path_factory.mktemp("uneven")
    by_spatial = {}
    for name in NAMES:
        by_spatial.setdefault(uneven.CASES[name][2], []).append(name)
    waits = {spatial: worker.start_ranks(uneven.steps, spatial, tmp, weights, names,
                                         spatial=spatial)
             for spatial, names in by_spatial.items()}
    ref = {name: uneven.one_step(weights, name, remat=False) for name in NAMES}
    one_process_remat = uneven.one_step(weights, "remat")
    losses = {name: jax_loss(nets, name) for name in NAMES if name != "remat"}
    losses["remat"] = losses["h96"]  # jax.checkpoint leaves the loss as it is
    ranks = {spatial: wait() for spatial, wait in waits.items()}
    return {"ranks": {name: [r[name] for r in ranks[uneven.CASES[name][2]]]
                      for name in NAMES},
            "ref": ref, "one_process_remat": one_process_remat, "jax": losses}


@pytest.mark.parametrize("height,spatial,multiple,message", [
    (97, 2, 1, "a multiple of spatial"),
    (32, 2, 1, None),
    (96, 4, 1, None),
    (100, 2, 1, None),
    (104, 4, 1, None),
    (96, 2, 32, None), (80, 2, 32, "a multiple of 32"), (192, 4, 1, None),
    (384, 8, 1, None), (384, 3, 1, None), (352, 4, 32, None),
    (66, 3, 1, None), (64, 4, 1, None), (192, 8, 1, None)])
def test_check_height_names_the_limit_it_refuses(height, spatial, multiple, message):
    # every (H, s) with H % s == 0 is taken (JAX's rule), for BtsModel
    # (`multiple` 32) also H a multiple of 32, below which JAX's model
    # cannot concatenate its skips either: bands that hold no row of a
    # level run it on the gathered map, a halo reaches past a short band,
    # and a coarse map whose upsample to the image is no integer factor is
    # resized whole (100 rows with all scales: 13 rows at 1/8); anything
    # else raises a ValueError that names the limit
    mesh = Mesh(None, 0, spatial, torch.device("cpu"), spatial=spatial)
    if message is None:
        check_height(mesh, height, 64, multiple)
        return
    with pytest.raises(ValueError, match="does not shard over spatial") as error:
        check_height(mesh, height, 64, multiple)
    assert message in str(error.value) and f"{height}x64" in str(error.value)


@pytest.mark.parametrize("name", NAMES)
def test_step_on_uneven_bands_matches_the_one_process_step(runs, name):
    # every rank returns the same metrics and gradients (bit for bit);
    # against the port's step on the whole batch in one process (remat
    # off): the metrics at rel 1e-5, the gradient at rel L2 <= 1e-4, the
    # BatchNorm running statistics at 1e-5
    ranks, ref = runs["ranks"][name], runs["ref"][name]
    for other in ranks[1:]:
        assert other["metrics"] == ranks[0]["metrics"]
        assert other["grads"] == digest(ranks[0]["grads"])
    got = ranks[0]
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for key, value in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=STEP_METRIC_RTOL,
                                   err_msg=key)
    rel = _rel_l2(_flat(got["grads"]), _flat(ref["grads"]))
    print(f"{name}: gradient rel L2 {rel:.3g}")
    assert rel <= STEP_GRAD_REL_L2, rel
    for key, value in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][key].numpy(), value.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_RTOL, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_step_on_uneven_bands_matches_the_jax_loss(runs, name):
    # the ranks' loss vs JAX's loss of the step on the whole batch on one
    # device (JAX's own sharded-vs-single-device tolerance)
    np.testing.assert_allclose(runs["ranks"][name][0]["metrics"]["loss"], runs["jax"][name],
                               rtol=JAX_LOSS_RTOL)


def test_remat_leaves_the_step_as_it_is(runs):
    # action.remat (the loss under torch.utils.checkpoint, recomputed in
    # the backward): in one process and under the mesh the metrics, the
    # gradients and the BatchNorm running statistics — updated once, not
    # again by the recompute — are those of the step without it, bit for
    # bit on the CPU
    for got, ref in ((runs["one_process_remat"], runs["ref"]["remat"]),
                     (runs["ranks"]["remat"][0], runs["ranks"]["h96"][0])):
        assert got["metrics"] == ref["metrics"]
        assert got["grads"].keys() == ref["grads"].keys()
        assert all((g is None and ref["grads"][k] is None) or torch.equal(g, ref["grads"][k])
                   for k, g in got["grads"].items())
        assert all(torch.equal(v, ref["stats"][k]) for k, v in got["stats"].items())
