"""Port parity: the photometric objective (photometric_loss, smooth_loss,
normalize_depth, min_reprojection_loss, reprojection_loss, total_loss)
against the JAX package on the same numpy inputs. Images are NHWC on the
JAX side, NCHW on the port's; the warp on both sides is the exact gather
warp."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.losses import photometric as jax_photometric
from unsupervised_pseuso_lidar_tpu.losses import reprojection as jax_reprojection
from unsupervised_pseuso_lidar_tpu.losses import smoothness as jax_smoothness
from unsupervised_pseuso_lidar_tpu.losses import total as jax_total
from unsupervised_pseuso_lidar_tpu_torch.losses import (
    photometric,
    reprojection,
    smoothness,
    total,
)

torch.set_num_threads(1)
B, H, W = 2, 24, 40
K = np.array([[40.0, 0, 20.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _frames(rng):
    # a smooth scene and its slightly shifted neighbours, so warps land
    # mostly in frame and the automask sees both outcomes
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([np.sin(xx * 0.3 + c) * np.cos(yy * 0.2 - c) for c in range(3)], -1)
    frames = [base + rng.normal(0, 0.05, (B, H, W, 3)).astype(np.float32)
              for _ in range(3)]
    return [f.astype(np.float32) for f in frames]


def _poses(rng):
    return np.concatenate(
        [rng.normal(0, 0.01, (B, 2, 3)), rng.normal(0, 0.1, (B, 2, 3))], -1
    ).astype(np.float32)


@pytest.mark.parametrize("no_ssim,clip", [(False, 0.5), (False, 0.0), (True, 0.5)])
def test_photometric_loss_matches_jax(no_ssim, clip):
    # includes the detached mean + clip·std clamp; atol 1e-6
    rng = np.random.default_rng(21)
    pred, target, _ = _frames(rng)
    ref = jax_photometric.photometric_loss(
        jnp.asarray(pred), jnp.asarray(target), no_ssim=no_ssim, clip_loss=clip
    )
    got = photometric.photometric_loss(
        _nchw(pred), _nchw(target), no_ssim=no_ssim, clip_loss=clip
    )
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(ref),
                               atol=1e-6)


def test_smooth_loss_and_normalize_depth_match_jax():
    rng = np.random.default_rng(21)
    maps = [rng.uniform(0.5, 20.0, (B, H // 2 ** s, W // 2 ** s, 1)).astype(np.float32)
            for s in range(3)]
    ref = jax_smoothness.smooth_loss([jnp.asarray(m) for m in maps])
    got = smoothness.smooth_loss([_nchw(m) for m in maps])
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    ref = jax_total.normalize_depth(jnp.asarray(maps[0]))
    got = total.normalize_depth(_nchw(maps[0]))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(ref),
                               rtol=1e-6)


@pytest.mark.parametrize("bidirectional,ident_scale,no_ssim",
                         [(True, 1.0, False), (False, 1.0, False),
                          (True, 1e4, False), (True, 1.0, True)])
def test_min_reprojection_loss_matches_jax(bidirectional, ident_scale, no_ssim):
    # two scales (the half-res one resized to full res inside the loss);
    # a mean of per-pixel minima: rel 1e-5
    rng = np.random.default_rng(21)
    tgt, ref0, ref1 = _frames(rng)
    poses = _poses(rng)
    depths = [rng.uniform(2.0, 8.0, (B, H // 2 ** s, W // 2 ** s, 1)).astype(np.float32)
              for s in range(2)]
    depths_ref0 = [d * rng.uniform(0.9, 1.1, d.shape).astype(np.float32)
                   for d in depths]
    ref = jax_reprojection.min_reprojection_loss(
        jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)],
        [jnp.asarray(d) for d in depths], jnp.asarray(poses), jnp.asarray(K),
        no_ssim=no_ssim, warp_impl="gather", ident_scale=ident_scale,
        depths_ref0=[jnp.asarray(d) for d in depths_ref0] if bidirectional else None,
    )
    got, _ = reprojection.min_reprojection_loss(
        _nchw(tgt), [_nchw(ref0), _nchw(ref1)], [_nchw(d) for d in depths],
        torch.from_numpy(poses), torch.from_numpy(K), no_ssim=no_ssim,
        ident_scale=ident_scale,
        depths_ref0=[_nchw(d) for d in depths_ref0] if bidirectional else None,
    )
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("bidirectional,ident_scale", [(True, 1.0), (False, 1.0), (True, 1.5)])
def test_automask_keep_matches_jax(bidirectional, ident_scale):
    # the fraction of pixels whose warp error wins the joint min (JAX
    # reports it with with_coverage): atol 1e-6, and the loss at rel 1e-5
    rng = np.random.default_rng(22)
    tgt, ref0, ref1 = _frames(rng)
    poses = _poses(rng)
    depths = [rng.uniform(2.0, 8.0, (B, H // 2 ** s, W // 2 ** s, 1)).astype(np.float32)
              for s in range(2)]
    depths_ref0 = [d * rng.uniform(0.9, 1.1, d.shape).astype(np.float32) for d in depths]
    ref_loss, coverage = jax_reprojection.min_reprojection_loss(
        jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)],
        [jnp.asarray(d) for d in depths], jnp.asarray(poses), jnp.asarray(K),
        warp_impl="gather", ident_scale=ident_scale, with_coverage=True,
        depths_ref0=[jnp.asarray(d) for d in depths_ref0] if bidirectional else None,
    )
    args = ([_nchw(tgt), _nchw(ref0), _nchw(ref1)], [_nchw(d) for d in depths])
    kwargs = dict(ident_scale=ident_scale,
                  depths_ref0=[_nchw(d) for d in depths_ref0] if bidirectional else None)
    loss, keep = reprojection.min_reprojection_loss(
        args[0][0], args[0][1:], args[1], torch.from_numpy(poses), torch.from_numpy(K),
        **kwargs)
    assert 0.0 < float(coverage["automask_keep"]) < 1.0  # both outcomes occur
    np.testing.assert_allclose(float(keep), float(coverage["automask_keep"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # total_loss hands it out in 'min' mode only
    disps = [[_nchw(d) for d in depths], [_nchw(d) for d in depths_ref0]]
    for mode, keys in (("min", ["automask_keep"]), ("mean", [])):
        *_, extra = total.total_loss(args[0][0], args[0][1:], disps, torch.from_numpy(poses),
                                     torch.from_numpy(K), mode=mode)
        assert sorted(extra) == keys


@pytest.mark.parametrize("smooth_on", ["depth", "disp"])
def test_total_loss_matches_jax(smooth_on):
    # disparities -> depth -> per-image normalization -> loss, with the
    # smoothness term on depth or disparity; rel 1e-5 on each term
    rng = np.random.default_rng(21)
    tgt, ref0, ref1 = _frames(rng)
    poses = _poses(rng)
    disps = [[rng.uniform(0.05, 0.9, (B, H, W, 1)).astype(np.float32)]
             for _ in range(2)]
    intr = np.broadcast_to(K, (B, 3, 3)).copy()
    ref = jax_total.total_loss(
        jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)],
        [[jnp.asarray(d) for d in f] for f in disps], jnp.asarray(poses),
        jnp.asarray(intr), mode="min", smooth_on=smooth_on,
        smooth_weight=0.001, depth_norm=True, warp_impl="gather",
    )
    got = total.total_loss(
        _nchw(tgt), [_nchw(ref0), _nchw(ref1)],
        [[_nchw(d) for d in f] for f in disps], torch.from_numpy(poses),
        torch.from_numpy(intr), mode="min", smooth_on=smooth_on,
        smooth_weight=0.001, depth_norm=True,
    )
    assert len(got) == 3 and sorted(got[2]) == ["automask_keep"]
    for g, r in zip(got[:2], ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


def test_total_loss_rejects_unported_modes():
    # every mode of the JAX package is ported; an unknown one raises
    t = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError, match="reprojection mode"):
        total.total_loss(t, [t, t], [[t[:, :1]], [t[:, :1]]],
                         torch.zeros(1, 2, 6), torch.eye(3), mode="bogus")


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# fixed seeds per mode, each drawing its own frames, poses and depths; the
# worst gradient on them is 4.8e-6 rel L2 (ssim; 3e-6 for the others), a
# margin of 20x to the 1e-4 bound. The gradient jumps where a sample
# crosses a pixel or a pixel crosses the ssim clamp, so another seed can
# land a pixel next to a jump (one did at 1.1e-4 on the module's frames)
@pytest.mark.parametrize("mode,seed", [("mean", 0), ("l1", 1), ("mse", 2), ("ssim", 3)])
def test_reprojection_loss_and_gradients_match_jax(mode, seed):
    # two scales (the half-res one resized to full res), all 3·S·B jobs in
    # one warp; the loss at rtol 1e-5, d/d(depths of both frames, poses)
    # vs jax.grad at rel L2 <= 1e-4
    rng = np.random.default_rng(seed)
    tgt, ref0, ref1 = _frames(rng)
    poses = _poses(rng)
    depths = [[rng.uniform(2.0, 8.0, (B, H // 2 ** s, W // 2 ** s, 1)).astype(np.float32)
               for s in range(2)] for _ in range(2)]
    flat = depths[0] + depths[1]

    def jax_loss(pose, *maps):
        return jax_reprojection.reprojection_loss(
            jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)],
            [list(maps[:2]), list(maps[2:])], pose, jnp.asarray(K), mode=mode,
            warp_impl="gather",
        )

    args = [jnp.asarray(poses)] + [jnp.asarray(d) for d in flat]
    ref = jax_loss(*args)
    ref_grads = jax.grad(jax_loss, argnums=tuple(range(5)))(*args)

    leaves = [torch.from_numpy(poses).requires_grad_()] + [
        _nchw(d).requires_grad_() for d in flat]
    got = reprojection.reprojection_loss(
        _nchw(tgt), [_nchw(ref0), _nchw(ref1)], [leaves[1:3], leaves[3:]], leaves[0],
        torch.from_numpy(K), mode=mode,
    )
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    grads = torch.autograd.grad(got, leaves)
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        g = g.numpy() if i == 0 else np.moveaxis(g.numpy(), 1, -1)
        assert float(np.abs(r).max()) > 0, i
        assert _rel_l2(g, r) <= 1e-4, (i, _rel_l2(g, r))


@pytest.mark.parametrize("mode", ["mean", "ssim"])
def test_total_loss_other_modes_match_jax(mode):
    # total_loss' non-'min' branch: disparities -> depth -> the
    # bidirectional loss + smoothness; rel 1e-5 on each term
    rng = np.random.default_rng(21)
    tgt, ref0, ref1 = _frames(rng)
    poses = _poses(rng)
    disps = [[rng.uniform(0.05, 0.9, (B, H, W, 1)).astype(np.float32)]
             for _ in range(2)]
    ref = jax_total.total_loss(
        jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)],
        [[jnp.asarray(d) for d in f] for f in disps], jnp.asarray(poses),
        jnp.asarray(K), mode=mode, warp_impl="gather",
    )
    got = total.total_loss(
        _nchw(tgt), [_nchw(ref0), _nchw(ref1)],
        [[_nchw(d) for d in f] for f in disps], torch.from_numpy(poses),
        torch.from_numpy(K), mode=mode,
    )
    assert len(got) == 3 and got[2] == {}
    for g, r in zip(got[:2], ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


def test_no_ssim_gradient_at_ties_matches_jax():
    # pred == target at 3 of 4 columns: jnp.abs' rule gives d|z|/dz = +1
    # at z = 0, so d/dpred of sum |target - pred| is -1 at every pixel.
    # torch.abs' rule (0 at a tie) gave 0 at the ties, the fault the port
    # had before utils/numerics.abs_
    rng = np.random.default_rng(21)
    target = rng.uniform(0, 1, (1, 4, 4, 3)).astype(np.float32)
    pred = target.copy()
    pred[:, :, 0] -= 0.25
    ref = jax.grad(lambda p: jnp.sum(jax_photometric.photometric_loss(
        p, jnp.asarray(target), no_ssim=True, clip_loss=0.0)))(jnp.asarray(pred))
    leaf = _nchw(pred).requires_grad_()
    photometric.photometric_loss(leaf, _nchw(target), no_ssim=True,
                                 clip_loss=0.0).sum().backward()
    got = np.moveaxis(leaf.grad.numpy(), 1, -1)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (got == -1.0).all()
    fault = _nchw(pred).requires_grad_()
    torch.abs(_nchw(target) - fault).sum().backward()
    assert (fault.grad[..., 1:] == 0).all() and (fault.grad[..., 0] == -1).all()
