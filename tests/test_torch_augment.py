"""Port parity for the training augmentations (data/augment.py) and their
place in the train step.

The port draws its parameters from its own stream (a CPU torch.Generator
seeded from (seed, step)), not JAX's fold_in/split stream, so the
transforms are held to JAX at fixed parameters: the ones JAX's own keys
give, recomputed here with jax.random exactly as data/augment.py of the
JAX package draws them. Images are NHWC on the JAX side, NCHW on the
port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_train import _compare_steps, jax_models  # noqa: F401
from unsupervised_pseuso_lidar_tpu.data import augment as jax_augment
from unsupervised_pseuso_lidar_tpu_torch.cli import train as train_cli
from unsupervised_pseuso_lidar_tpu_torch.data import augment
from unsupervised_pseuso_lidar_tpu_torch.train import trainer as trainer_module

torch.set_num_threads(1)
B, H, W = 3, 10, 14
# images are O(1) after normalization; one multiply and one add a pixel
ATOL = 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), -3, -1)


def _jax_params(seed, step, batch, jitter=True, flip=True):
    """The parameters JAX's augment_batch(step, ..., seed) draws, as the
    port's AugmentParams (identity where an augmentation is off)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    flips = np.zeros(batch, bool)
    add, scale = np.zeros(batch, np.float32), np.ones(batch, np.float32)
    if flip:
        rng, k = jax.random.split(rng)
        flips = np.array(jax.random.bernoulli(k, 0.5, (batch,)))
    if jitter:
        rng, k = jax.random.split(rng)
        k_b, k_c = jax.random.split(k)
        add = np.array(jax.random.uniform(k_b, (batch, 1, 1, 1), minval=-0.2,
                                            maxval=0.2)).reshape(-1)
        scale = np.array(jax.random.uniform(k_c, (batch, 1, 1, 1), minval=0.8,
                                              maxval=1.2)).reshape(-1)
    return augment.AugmentParams(torch.from_numpy(add), torch.from_numpy(scale),
                                 torch.from_numpy(flips))


def _batch(seed):
    rng = np.random.default_rng(seed)
    k = np.array([[20.0, 0, 6.5], [0, 20.0, 5.0], [0, 0, 1]], np.float32)
    return {
        "tgt": rng.normal(size=(B, H, W, 3)).astype(np.float32),
        "ref_imgs": rng.normal(size=(B, 2, H, W, 3)).astype(np.float32),
        "intrinsics": (k + rng.normal(0, 0.5, (B, 3, 3))).astype(np.float32),
        "groundtruth": rng.uniform(0, 80, (B, H, W)).astype(np.float32),
        "oxts": rng.normal(0, 0.3, (B, 2, 6)).astype(np.float32),
    }


def _port_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tgt"], out["ref_imgs"] = _nchw(batch["tgt"]), _nchw(batch["ref_imgs"])
    return out


def test_color_jitter_matches_jax():
    batch = _batch(51)
    key = jax.random.PRNGKey(7)
    ref_tgt, ref_refs = jax_augment.color_jitter(key, jnp.asarray(batch["tgt"]),
                                                 jnp.asarray(batch["ref_imgs"]))
    k_b, k_c = jax.random.split(key)
    add = torch.from_numpy(np.array(jax.random.uniform(
        k_b, (B, 1, 1, 1), minval=-0.2, maxval=0.2)).reshape(-1))
    scale = torch.from_numpy(np.array(jax.random.uniform(
        k_c, (B, 1, 1, 1), minval=0.8, maxval=1.2)).reshape(-1))
    tgt, refs = augment.color_jitter(_nchw(batch["tgt"]), _nchw(batch["ref_imgs"]),
                                     add, scale)
    np.testing.assert_allclose(_nhwc(tgt), np.asarray(ref_tgt), atol=ATOL)
    np.testing.assert_allclose(_nhwc(refs), np.asarray(ref_refs), atol=ATOL)


def test_horizontal_flip_matches_jax():
    # at least one sample flipped and one not; cx' = W - 1 - cx exactly
    batch = _batch(51)
    key = next(k for k in (jax.random.PRNGKey(s) for s in range(20))
               if 0 < int(jax.random.bernoulli(k, 0.5, (B,)).sum()) < B)
    ref = jax_augment.horizontal_flip(key, jnp.asarray(batch["tgt"]),
                                      jnp.asarray(batch["ref_imgs"]),
                                      jnp.asarray(batch["intrinsics"]))
    flip = torch.from_numpy(np.array(ref[3]))
    tgt, refs, intr = augment.horizontal_flip(
        _nchw(batch["tgt"]), _nchw(batch["ref_imgs"]),
        torch.from_numpy(batch["intrinsics"]), flip)
    np.testing.assert_array_equal(_nhwc(tgt), np.asarray(ref[0]))
    np.testing.assert_array_equal(_nhwc(refs), np.asarray(ref[1]))
    np.testing.assert_array_equal(intr.numpy(), np.asarray(ref[2]))
    f = flip.numpy()
    np.testing.assert_array_equal(intr[f, 0, 2].numpy(),
                                  (W - 1) - batch["intrinsics"][f, 0, 2])
    np.testing.assert_array_equal(intr[~f].numpy(), batch["intrinsics"][~f])


@pytest.mark.parametrize("jitter,flip", [(True, True), (True, False), (False, True)])
def test_augment_batch_matches_jax(jitter, flip):
    # the GT flip and the OXTS mirror follow the same decisions
    batch = _batch(51)
    for seed, step in ((0, 0), (42, 17)):
        ref = jax_augment.augment_batch(jnp.asarray(step),
                                        {k: jnp.asarray(v) for k, v in batch.items()},
                                        jitter=jitter, flip=flip, seed=seed)
        got = augment.augment_batch(_port_batch(batch), _jax_params(seed, step, B, jitter, flip),
                                    jitter=jitter, flip=flip)
        assert sorted(got) == sorted(ref)
        for key in ("tgt", "ref_imgs"):
            np.testing.assert_allclose(_nhwc(got[key]), np.asarray(ref[key]), atol=ATOL,
                                       err_msg=key)
        for key in ("intrinsics", "groundtruth", "oxts"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_the_triplet_gets_the_same_parameters():
    # refs equal to the target stay equal to it under every draw
    rng = np.random.default_rng(51)
    tgt = torch.from_numpy(rng.normal(size=(8, 3, H, W)).astype(np.float32))
    batch = {"tgt": tgt, "ref_imgs": torch.stack([tgt, tgt], 1).clone(),
             "intrinsics": torch.eye(3).repeat(8, 1, 1)}
    for step in range(3):
        params = augment.draw_params(8, 5, step)
        out = augment.augment_batch(batch, params, jitter=True, flip=True)
        for i in range(2):
            assert torch.equal(out["ref_imgs"][:, i], out["tgt"])
        assert not torch.equal(out["tgt"], tgt)


def test_draws_depend_only_on_seed_and_step():
    a, b = augment.draw_params(4096, 42, 10), augment.draw_params(4096, 42, 10)
    assert all(torch.equal(x, y) for x, y in ((a.add, b.add), (a.scale, b.scale),
                                               (a.flip, b.flip)))
    c, d = augment.draw_params(4096, 42, 11), augment.draw_params(4096, 43, 10)
    assert not torch.equal(a.add, c.add) and not torch.equal(a.add, d.add)
    assert a.add.dtype == a.scale.dtype == torch.float32 and a.flip.dtype == torch.bool
    assert float(a.add.min()) >= -0.2 and float(a.add.max()) < 0.2
    assert float(a.scale.min()) >= 0.8 and float(a.scale.max()) < 1.2
    assert 0.45 < float(a.flip.float().mean()) < 0.55


def _config(tmp_path, **action):
    raw = {"model": {"name": "aug", "pose": {"name": "PoseNet"}},
           "datasets": {"augmentation": {"image_height": 32, "image_width": 64,
                                         "color_jitter": True, "hflip": True}},
           "action": {"batch_size": 2, "loss_mode": "min", "log_freq": 100,
                      "checkpoint_dir": str(tmp_path / "ckpt"), **action}}
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / f"cfg{len(action)}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_a_resumed_run_draws_what_the_uninterrupted_run_drew(tmp_path, monkeypatch):
    # two epochs of one synthetic batch, uninterrupted and as epoch 0 then
    # a resume: the same (seed, step) draws, and the same weights at the end
    draws = []

    def recording(batch_size, seed, step):
        params = augment.draw_params(batch_size, seed, step)
        draws.append((seed, step, params))
        return params

    monkeypatch.setattr(trainer_module, "draw_params", recording)

    def run(path, epochs):
        return train_cli.main(["--config", path, "--synthetic", "--epochs", str(epochs),
                               "--synthetic-batches", "1", "--device", "cpu"])

    whole = run(_config(tmp_path / "a"), 2)
    first = list(draws)
    draws.clear()
    run(_config(tmp_path / "b"), 1)
    resumed = run(_config(tmp_path / "b", from_scratch=False), 2)
    assert [(s, t) for s, t, _ in first] == [(s, t) for s, t, _ in draws] == [(42, 0), (42, 1)]
    for (_, _, x), (_, _, y) in zip(first, draws):
        assert torch.equal(x.add, y.add) and torch.equal(x.flip, y.flip)
    a = whole.state.depth_model.state_dict()
    b = resumed.state.depth_model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_augmented_train_step_matches_jax(jax_models, monkeypatch, accum_steps):  # noqa: F811
    # color_jitter and hflip in the full step (test_torch_train's harness
    # and margins), the port given the parameters JAX draws at step 0. As
    # there, the batch and draw are fixed where no gradient key sits next
    # to a jump: here a 1e-7 relative perturbation of the weights moves the
    # port's own gradient by <= 5e-5 per key (measured on the CPU), while
    # at batch seed 1 / draw seed 5 it moves the finest disparity head's
    # bias by 1e-2, which no parity margin can cover. With accum_steps 2,
    # JAX augments each micro-batch of 2 with the draws of (seed, step) at
    # size 2, and so does the port: one draw, applied to both (batch seed
    # 5: worst key 7e-5 on the CPU, where seeds 2, 3 and 6 put a key past
    # 1e-3)
    seed = 1  # a draw that flips one of the two samples
    params = _jax_params(seed, 0, 2)
    assert int(params.flip.sum()) == 1
    monkeypatch.setattr(trainer_module, "draw_params",
                        lambda batch_size, s, step: _jax_params(s, step, batch_size))
    applied = []

    def recording(batch, params, **kwargs):
        applied.append(params)
        return augment.augment_batch(batch, params, **kwargs)

    monkeypatch.setattr(trainer_module, "augment_batch", recording)
    _compare_steps(jax_models, batch_size=2 * accum_steps, accum_steps=accum_steps,
                   seed={1: 4, 2: 5}[accum_steps], color_jitter=True, hflip=True,
                   aug_seed=seed)
    assert len(applied) == accum_steps
    for p in applied:
        assert len(p.flip) == 2
        assert all(torch.equal(x, y) for x, y in ((p.add, params.add), (p.scale, params.scale),
                                                   (p.flip, params.flip)))
