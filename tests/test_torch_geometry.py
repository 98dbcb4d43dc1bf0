"""Port parity: SE(3), the warp's sample coordinates, disp_to_depth,
resize_bilinear, the pseudo-LiDAR backprojection, the OXTS poses and the
velodyne rasterizer against the JAX package, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.geometry import oxts as jax_oxts
from unsupervised_pseuso_lidar_tpu.geometry import se3 as jax_se3
from unsupervised_pseuso_lidar_tpu.geometry import warp as jax_warp
from unsupervised_pseuso_lidar_tpu.ops.resample import resize_bilinear as jax_resize
from unsupervised_pseuso_lidar_tpu.pseudolidar import velo2img as jax_velo2img
from unsupervised_pseuso_lidar_tpu.pseudolidar.projector import (
    depth_to_pointcloud as jax_depth_to_pointcloud,
)
from unsupervised_pseuso_lidar_tpu_torch.geometry import oxts, se3, warp
from unsupervised_pseuso_lidar_tpu_torch.ops.resample import resize_bilinear
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar import velo2img
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
    depth_to_pointcloud,
)

torch.set_num_threads(1)

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


def _poses(rng, batch):
    return np.concatenate(
        [rng.normal(0, 0.05, (batch, 3)), rng.normal(0, 0.5, (batch, 3))],
        axis=-1,
    ).astype(np.float32)


@pytest.mark.parametrize("invert", [False, True])
def test_pose_matrix_matches_jax(invert):
    rng = np.random.default_rng(5)
    vec = _poses(rng, 4)
    ref = jax_se3.pose_matrix(jnp.asarray(vec), invert=invert)
    got = se3.pose_matrix(torch.from_numpy(vec), invert=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_invert_pose_and_inverted_parameters_match_jax():
    rng = np.random.default_rng(5)
    vec = _poses(rng, 3)
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
    rng = np.random.default_rng(5)
    batch, height, width = 3, 24, 40
    depth = rng.uniform(1.0, 30.0, (batch, height, width)).astype(np.float32)
    transform = np.array(jax_se3.pose_matrix(jnp.asarray(_poses(rng, batch))))
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
    rng = np.random.default_rng(5)
    disp = rng.uniform(0, 1, (2, 1, 6, 8)).astype(np.float32)
    ref = jax_warp.disp_to_depth(jnp.asarray(disp))
    got = warp.disp_to_depth(torch.from_numpy(disp))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("out_hw", [(12, 20), (7, 33), (6, 10)])
def test_resize_bilinear_matches_jax(out_hw):
    # F.interpolate(align_corners=False) vs JAX's 2-sparse interpolation
    # matrices at fp32 HIGHEST: atol 1e-5
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 6, 10, 1)).astype(np.float32)
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
    rng = np.random.default_rng(5)
    depth = rng.uniform(2.0, 60.0, (2, 40, 120)).astype(np.float32)
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


# --------------------------------------------------------------------------
# OXTS poses (host float64) and the velodyne rasterizer
# --------------------------------------------------------------------------

def _packet(module, rng):
    return module.OxtsPacket(49.0 + rng.uniform(-1, 1), 8.4 + rng.uniform(-1, 1),
                             110 + rng.uniform(0, 10), *rng.uniform(-0.3, 0.3, 3))


def test_oxts_poses_match_jax():
    # float64 on the host in both packages: rel 1e-12
    rng = np.random.default_rng(12)
    for _ in range(4):
        state = rng.bit_generator.state
        packet = _packet(oxts, rng)
        rng.bit_generator.state = state
        scale = np.cos(np.radians(packet.lat))
        np.testing.assert_allclose(oxts.pose_from_oxts_packet(packet, scale),
                                   jax_oxts.pose_from_oxts_packet(_packet(jax_oxts, rng), scale),
                                   rtol=1e-12, atol=0)
    line = "49.01 8.43 114.5 0.01 0.005 0.3 " + " ".join(["0.5"] * 24)
    assert oxts.parse_oxts_line(line) == tuple(jax_oxts.parse_oxts_line(line))
    with pytest.raises(ValueError, match="fields"):
        oxts.parse_oxts_line("1 2 3")


@pytest.mark.parametrize("angle", [0.0, 3e-8, 1e-3, 0.4, 2.5])
def test_axis_angle_from_matrix_matches_jax(angle):
    # below 1e-7 rad both take the first-order skew branch: rel 1e-12
    axis = np.array([0.3, -0.8, 0.5]) / np.linalg.norm([0.3, -0.8, 0.5])
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    got = oxts.axis_angle_from_matrix(rot)
    np.testing.assert_allclose(got, jax_oxts.axis_angle_from_matrix(rot), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, angle * axis, rtol=1e-7, atol=1e-15)


def test_relative_pose_6dof_matches_jax():
    rng = np.random.default_rng(13)
    world = [oxts.pose_from_oxts_packet(_packet(oxts, rng), 0.65) for _ in range(2)]
    imu_to_cam = np.eye(4)
    imu_to_cam[:3, :3] = oxts.rotz(0.03) @ oxts.roty(-1.2) @ oxts.rotx(0.01)
    imu_to_cam[:3, 3] = [0.3, -0.8, 1.1]
    got = oxts.relative_pose_6dof(world[0], world[1], imu_to_cam)
    ref = jax_oxts.relative_pose_6dof(world[0], world[1], imu_to_cam)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def _scan(rng, n, width, height):
    """[n, 4] velodyne points: most project into a width x height image
    under P / T_VELO_CAM, some behind the sensor, out of frame or beyond
    120 m; none within 1e-3 px of a pixel edge or 1e-3 m of the range
    limit (the edge points are returned apart, [m, 4])."""
    u = rng.uniform(-0.2 * width, 1.2 * width, n)
    v = rng.uniform(-0.2 * height, 1.2 * height, n)
    z = rng.uniform(1.0, 140.0, n) * np.where(rng.uniform(size=n) < 0.1, -1.0, 1.0)
    x = (u - P[0, 2]) * z / P[0, 0] - P[0, 3] / P[0, 0]
    y = (v - P[1, 2]) * z / P[1, 1] - P[1, 3] / P[1, 1]
    rect = np.stack([x, y, z, np.ones(n)], -1)
    velo = rect @ np.linalg.inv(T_VELO_CAM.astype(np.float64)).T
    pts = np.concatenate([velo[:, :3], rng.uniform(0, 1, (n, 1))], -1).astype(np.float32)
    # where the fp32 chain puts them, in float64
    cam = pts[:, :3].astype(np.float64) @ T_VELO_CAM[:3, :3].T + T_VELO_CAM[:3, 3]
    uvw = cam @ P[:, :3].T.astype(np.float64) + P[:, 3]
    uu, vv = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
    dist = np.linalg.norm(pts[:, :3].astype(np.float64), axis=-1)

    def near(a):
        return np.abs(a - np.round(a)) < 1e-3

    edge = near(uu) | near(vv) | (np.abs(dist - 120.0) < 1e-3)
    return pts[~edge], pts[edge]


def test_velo_to_depth_image_matches_jax():
    # 20,000 points at 120x40: the same pixels set, values at rel 1e-6
    # (two summation orders of the same fp32 products); JAX's scatter-min
    # is the reference. Points within rounding of a pixel edge may land
    # on the neighbouring pixel in one package: they are kept apart and
    # counted, and the full scan may differ at no more pixels than that
    rng = np.random.default_rng(14)
    width, height = 120, 40
    clean, edge = _scan(rng, 20000, width, height)

    def both(points):
        ref = np.asarray(jax_velo2img.project_velo_to_depth_image(
            jnp.asarray(points), jnp.asarray(T_VELO_CAM), jnp.asarray(P),
            width=width, height=height))
        got = velo2img.project_velo_to_depth_image(
            torch.from_numpy(points), torch.from_numpy(T_VELO_CAM), torch.from_numpy(P),
            width=width, height=height)
        assert got.dtype == torch.float32 and got.shape == (height, width)
        return got.numpy(), ref

    got, ref = both(clean)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert 1000 < (ref > 0).sum() < width * height
    full = np.concatenate([clean, edge])
    got, ref = both(full)
    differ = int(((got > 0) != (ref > 0)).sum() + ((got > 0) & (ref > 0)
                                                    & ~np.isclose(got, ref, rtol=1e-6)).sum())
    assert differ <= 2 * len(edge), (differ, len(edge))
    # and the [N, 3] form drops nothing but reflectance
    np.testing.assert_array_equal(both(clean[:, :3])[0], both(clean)[0])


def test_img_to_velo_matches_jax():
    # the inverse through the projector: the same points at atol 1e-3 m
    rng = np.random.default_rng(5)
    depth = rng.uniform(2.0, 60.0, (40, 120)).astype(np.float32)
    depth[::5, ::3] = 0.0
    ref = jax_velo2img.project_img_to_velo(depth, T_VELO_CAM, P)
    got = velo2img.project_img_to_velo(depth, T_VELO_CAM, P)
    assert got.shape == ref.shape and got.shape[1] == 4
    np.testing.assert_allclose(got, ref, atol=1e-3)
