"""Port parity: the photometric objective (photometric_loss, smooth_loss,
normalize_depth, min_reprojection_loss, total_loss) against the JAX
package on the same numpy inputs. Images are NHWC on the JAX side, NCHW
on the port's; the warp on both sides is the exact gather warp."""

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
RNG = np.random.default_rng(21)
B, H, W = 2, 24, 40
K = np.array([[40.0, 0, 20.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _frames():
    # a smooth scene and its slightly shifted neighbours, so warps land
    # mostly in frame and the automask sees both outcomes
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([np.sin(xx * 0.3 + c) * np.cos(yy * 0.2 - c) for c in range(3)], -1)
    frames = [base + RNG.normal(0, 0.05, (B, H, W, 3)).astype(np.float32)
              for _ in range(3)]
    return [f.astype(np.float32) for f in frames]


def _poses():
    return np.concatenate(
        [RNG.normal(0, 0.01, (B, 2, 3)), RNG.normal(0, 0.1, (B, 2, 3))], -1
    ).astype(np.float32)


@pytest.mark.parametrize("no_ssim,clip", [(False, 0.5), (False, 0.0), (True, 0.5)])
def test_photometric_loss_matches_jax(no_ssim, clip):
    # includes the detached mean + clip·std clamp; atol 1e-6
    pred, target, _ = _frames()
    ref = jax_photometric.photometric_loss(
        jnp.asarray(pred), jnp.asarray(target), no_ssim=no_ssim, clip_loss=clip
    )
    got = photometric.photometric_loss(
        _nchw(pred), _nchw(target), no_ssim=no_ssim, clip_loss=clip
    )
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(ref),
                               atol=1e-6)


def test_smooth_loss_and_normalize_depth_match_jax():
    maps = [RNG.uniform(0.5, 20.0, (B, H // 2 ** s, W // 2 ** s, 1)).astype(np.float32)
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
    tgt, ref0, ref1 = _frames()
    poses = _poses()
    depths = [RNG.uniform(2.0, 8.0, (B, H // 2 ** s, W // 2 ** s, 1)).astype(np.float32)
              for s in range(2)]
    depths_ref0 = [d * RNG.uniform(0.9, 1.1, d.shape).astype(np.float32)
                   for d in depths]
    ref = jax_reprojection.min_reprojection_loss(
        jnp.asarray(tgt), [jnp.asarray(ref0), jnp.asarray(ref1)],
        [jnp.asarray(d) for d in depths], jnp.asarray(poses), jnp.asarray(K),
        no_ssim=no_ssim, warp_impl="gather", ident_scale=ident_scale,
        depths_ref0=[jnp.asarray(d) for d in depths_ref0] if bidirectional else None,
    )
    got = reprojection.min_reprojection_loss(
        _nchw(tgt), [_nchw(ref0), _nchw(ref1)], [_nchw(d) for d in depths],
        torch.from_numpy(poses), torch.from_numpy(K), no_ssim=no_ssim,
        ident_scale=ident_scale,
        depths_ref0=[_nchw(d) for d in depths_ref0] if bidirectional else None,
    )
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("smooth_on", ["depth", "disp"])
def test_total_loss_matches_jax(smooth_on):
    # disparities -> depth -> per-image normalization -> loss, with the
    # smoothness term on depth or disparity; rel 1e-5 on each term
    tgt, ref0, ref1 = _frames()
    poses = _poses()
    disps = [[RNG.uniform(0.05, 0.9, (B, H, W, 1)).astype(np.float32)]
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
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


def test_total_loss_rejects_unported_modes():
    t = torch.zeros(1, 3, 4, 4)
    with pytest.raises(NotImplementedError):
        total.total_loss(t, [t, t], [[t[:, :1]], [t[:, :1]]],
                         torch.zeros(1, 2, 6), torch.eye(3), mode="mean")
