"""Port parity: SE(3), the warp's sample coordinates, disp_to_depth,
resize_bilinear and the pseudo-LiDAR backprojection against the JAX
package, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.geometry import se3 as jax_se3
from unsupervised_pseuso_lidar_tpu.geometry import warp as jax_warp
from unsupervised_pseuso_lidar_tpu.ops.resample import resize_bilinear as jax_resize
from unsupervised_pseuso_lidar_tpu.pseudolidar.projector import (
    depth_to_pointcloud as jax_depth_to_pointcloud,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry import se3, warp
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
    depth_to_pointcloud,
)

torch.set_num_threads(1)
RNG = np.random.default_rng(5)

# a small camera sized for a 40x120 depth map (baseline terms included)
# and the real KITTI 2011_09_26 velodyne->camera transform
P = np.array(
    [[100.0, 0.0, 60.0, 0.5],
     [0.0, 100.0, 20.0, 0.01],
     [0.0, 0.0, 1.0, 0.0]], dtype=np.float32)
T_VELO_CAM = np.array(
    [[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
     [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
     [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)


def _poses(batch):
    return np.concatenate(
        [RNG.normal(0, 0.05, (batch, 3)), RNG.normal(0, 0.5, (batch, 3))],
        axis=-1,
    ).astype(np.float32)


@pytest.mark.parametrize("invert", [False, True])
def test_pose_matrix_matches_jax(invert):
    vec = _poses(4)
    ref = jax_se3.pose_matrix(jnp.asarray(vec), invert=invert)
    got = se3.pose_matrix(torch.from_numpy(vec), invert=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_invert_pose_and_inverted_parameters_match_jax():
    vec = _poses(3)
    mat = np.array(jax_se3.pose_matrix(jnp.asarray(vec)))
    ref = jax_se3.invert_pose(jnp.asarray(mat))
    got = se3.invert_pose(torch.from_numpy(mat))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    ref = jax_se3.transformation_from_parameters(
        jnp.asarray(vec[:, None, :3]), jnp.asarray(vec[:, None, 3:]), invert=True
    )
    got = se3.transformation_from_parameters(
        torch.from_numpy(vec[:, None, :3]), torch.from_numpy(vec[:, None, 3:]),
        invert=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_warp_coords_matches_jax():
    # the folded K·T·K⁻¹ form in fp32 on both sides; coords are O(1) with
    # a 1/z division, rtol 1e-5 + atol 1e-5
    batch, height, width = 3, 24, 40
    depth = RNG.uniform(1.0, 30.0, (batch, height, width)).astype(np.float32)
    transform = np.array(jax_se3.pose_matrix(jnp.asarray(_poses(batch))))
    k = np.array([[50.0, 0, 20.0], [0, 50.0, 12.0], [0, 0, 1]], np.float32)
    intr = np.broadcast_to(k, (batch, 3, 3)).copy()
    ref = jax_warp.warp_coords(
        jnp.asarray(depth), jnp.asarray(transform), jnp.asarray(intr)
    )
    got = warp.warp_coords(
        torch.from_numpy(depth), torch.from_numpy(transform), torch.from_numpy(intr)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # a shared [3, 3] camera broadcasts like a per-row one
    got_shared = warp.warp_coords(
        torch.from_numpy(depth), torch.from_numpy(transform), torch.from_numpy(k)
    )
    np.testing.assert_array_equal(got_shared.numpy(), got.numpy())


def test_disp_to_depth_matches_jax():
    disp = RNG.uniform(0, 1, (2, 1, 6, 8)).astype(np.float32)
    ref = jax_warp.disp_to_depth(jnp.asarray(disp))
    got = warp.disp_to_depth(torch.from_numpy(disp))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("out_hw", [(12, 20), (7, 33), (6, 10)])
def test_resize_bilinear_matches_jax(out_hw):
    # F.interpolate(align_corners=False) vs JAX's 2-sparse interpolation
    # matrices at fp32 HIGHEST: atol 1e-5
    img = RNG.normal(size=(2, 6, 10, 1)).astype(np.float32)
    ref = jax_resize(jnp.asarray(img), *out_hw)
    got = resize_bilinear(torch.from_numpy(np.moveaxis(img, -1, 1)), *out_hw)
    np.testing.assert_allclose(
        np.moveaxis(got.numpy(), 1, -1), np.asarray(ref), atol=1e-5
    )


@pytest.mark.parametrize("sparsity", [0, 3])
def test_depth_to_pointcloud_matches_jax(sparsity):
    # points within 1e-3 m (fp32 matrix inverse and 4x4 product at tens of
    # meters); the valid masks agree except where a point sits on the crop
    # boundary to within that rounding
    depth = RNG.uniform(2.0, 60.0, (2, 40, 120)).astype(np.float32)
    depth[:, ::7, ::5] = 0.0  # no-return pixels
    ref_pts, ref_valid = jax_depth_to_pointcloud(
        jnp.asarray(depth), jnp.asarray(P), jnp.asarray(T_VELO_CAM),
        sparsity=sparsity,
    )
    pts, valid = depth_to_pointcloud(
        torch.from_numpy(depth), torch.from_numpy(P), torch.from_numpy(T_VELO_CAM),
        sparsity=sparsity,
    )
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref_pts), atol=1e-3)
    mismatch = np.mean(valid.numpy() != np.asarray(ref_valid))
    assert mismatch < 1e-3, mismatch
    assert valid.any()
