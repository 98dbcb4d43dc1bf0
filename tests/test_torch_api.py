"""The public API the JAX package's __init__s export, in the port: the
camera functions (geometry/camera.py), the rest of geometry/se3.py and
geometry/calibration.py, losses/total.Losses, losses/photometric.l1_loss,
models/registry.register_model, and each package's exported names. Each
function is held to its JAX counterpart on seeded numpy inputs: fp32 at
1e-6, the float64 numpy calibration functions exactly."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.geometry import calibration as jax_calibration
from unsupervised_pseuso_lidar_tpu.geometry import camera as jax_camera
from unsupervised_pseuso_lidar_tpu.geometry import se3 as jax_se3
from unsupervised_pseuso_lidar_tpu.losses import photometric as jax_photometric
from unsupervised_pseuso_lidar_tpu.losses import total as jax_total
from unsupervised_pseuso_lidar_tpu.models import registry as jax_registry
from unsupervised_pseuso_lidar_tpu_torch.geometry import calibration, camera, se3
from unsupervised_pseuso_lidar_tpu_torch.losses.photometric import l1_loss
from unsupervised_pseuso_lidar_tpu_torch.losses.total import Losses
from unsupervised_pseuso_lidar_tpu_torch.models import registry

torch.set_num_threads(1)
B, H, W = 3, 12, 20
K = np.array([[21.0, 0.0, 9.5], [0.0, 19.0, 5.5], [0.0, 0.0, 1.0]], np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, ref, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("height,width", [(H, W), (1, 5), (7, 1)])
def test_pixel_grid_matches_jax(height, width):
    got = camera.pixel_grid(height, width)
    assert got.shape == (3, height, width) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_camera.pixel_grid(height, width)))


@pytest.mark.parametrize("batched_k", [True, False])
def test_backproject_and_project_match_jax(batched_k):
    rng = _rng(1)
    depth = rng.uniform(1.0, 30.0, (B, H, W)).astype(np.float32)
    intr = np.stack([K * np.float32(1 + 0.1 * i) for i in range(B)]) if batched_k else K
    intr = intr.astype(np.float32)
    if batched_k:
        intr[:, 2, 2] = 1.0
    vec = np.concatenate([rng.normal(0, 0.05, (B, 3)), rng.normal(0, 0.5, (B, 3))],
                         -1).astype(np.float32)
    transform = np.array(jax_se3.pose_matrix(jnp.asarray(vec)))
    ref_pts = jax_camera.backproject(jnp.asarray(depth), jnp.asarray(intr))
    pts = camera.backproject(torch.from_numpy(depth), torch.from_numpy(intr))
    assert pts.shape == (B, H, W, 3)
    # depth up to 30: compare relative to each point's magnitude
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref_pts), rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref_pts).max()))
    ref = jax_camera.project(ref_pts, jnp.asarray(intr), jnp.asarray(transform))
    got = camera.project(torch.from_numpy(np.array(ref_pts)), torch.from_numpy(intr),
                         torch.from_numpy(transform))
    assert got.shape == (B, H, W, 2)
    _close(got, ref)
    # backproject then project with the identity returns the pixel grid
    ident = torch.eye(4).expand(B, 4, 4)
    grid = camera.project(pts, torch.from_numpy(intr), ident)
    u = (torch.arange(W) / (W - 1) - 0.5) * 2
    np.testing.assert_allclose(grid[0, 0, :, 0].numpy(), u.numpy(), atol=1e-5)


def test_scale_intrinsics_matches_jax():
    intr = np.stack([K, 2 * K]).astype(np.float32)
    for sx, sy in ((0.5, 0.25), (1280 / 1242, 384 / 375)):
        ref = jax_camera.scale_intrinsics(jnp.asarray(intr), sx, sy)
        got = camera.scale_intrinsics(torch.from_numpy(intr), sx, sy)
        _close(got, ref)


def _rotations(rng, n):
    vec = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    return np.array(jax_se3.rot_from_axisangle(jnp.asarray(vec)))[:, :3, :3]


def test_is_rotation_matrix_matches_jax():
    rng = _rng(2)
    rots = _rotations(rng, 6)
    bad = rots.copy()
    bad[1] *= 1.001
    bad[3, 0, 1] += 1e-3
    for batch in (rots, bad):
        got = se3.is_rotation_matrix(torch.from_numpy(batch))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_se3.is_rotation_matrix(batch)))
    assert se3.is_rotation_matrix(torch.from_numpy(bad)).tolist() == [
        True, False, True, False, True, True]
    assert bool(se3.is_rotation_matrix(np.eye(3, dtype=np.float32)))


def test_mat2euler_matches_jax():
    rng = _rng(3)
    rots = _rotations(rng, 8)
    # the singular branch: cos(y) = 0
    c, s = np.cos(0.3), np.sin(0.3)
    singular = np.array([[0, s, c], [0, c, -s], [-1, 0, 0]], np.float32)
    rots = np.concatenate([rots, singular[None]])
    got = se3.mat2euler(torch.from_numpy(rots))
    _close(got, jax_se3.mat2euler(jnp.asarray(rots)))
    assert float(got[-1, 2]) == 0.0


@pytest.mark.parametrize("mode", ["euler", None])
def test_pose_vec2mat_matches_jax(mode):
    vec = _rng(4).normal(0, 0.3, (B, 6)).astype(np.float32)
    got = se3.pose_vec2mat(torch.from_numpy(vec), mode=mode)
    _close(got, jax_se3.pose_vec2mat(jnp.asarray(vec), mode=mode))
    if mode:
        assert got.shape == (B, 3, 4)
    with pytest.raises(ValueError, match="not supported"):
        se3.pose_vec2mat(torch.from_numpy(vec), mode="quat")


@pytest.mark.parametrize("rows", [3, 4])
def test_inverse_rigid_transform_is_jax_exactly(rows):
    rng = _rng(5)
    rot = _rotations(rng, 1)[0].astype(np.float64)
    transform = np.eye(4)[:rows]
    transform[:3, :3], transform[:3, 3] = rot, rng.normal(0, 2, 3)
    got = calibration.inverse_rigid_transform(transform)
    np.testing.assert_array_equal(got, jax_calibration.inverse_rigid_transform(transform))
    assert got.shape == (rows, 4) and got.dtype == np.float64


@pytest.mark.parametrize("scale,front", [(1.0, None), (-2.5, None), (0.7, "behind")])
def test_decompose_projection_is_jax_exactly(scale, front):
    rng = _rng(6)
    rot = _rotations(rng, 1)[0].astype(np.float64)
    k = np.array([[721.5, 0.3, 609.6], [0.0, 721.5, 172.9], [0.0, 0.0, 1.0]])
    t = rng.normal(0, 1, 3)
    proj = scale * k @ np.hstack([rot, t[:, None]])
    point = None
    if front:
        # a world point behind the camera's canonical decomposition
        point = rot.T @ (np.array([0.1, -0.2, -5.0]) - t)
    got = calibration.decompose_projection(proj, point)
    ref = jax_calibration.decompose_projection(proj, point)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    kk, rr, tt = got
    assert np.isclose(np.linalg.det(rr), 1.0) and kk[2, 2] == 1.0
    recon = kk @ np.hstack([rr, tt[:, None]])
    np.testing.assert_allclose(recon * (proj.ravel() @ recon.ravel()) / (recon.ravel() @ recon.ravel()),
                               proj, rtol=1e-9, atol=1e-9)


def test_l1_loss_matches_jax():
    rng = _rng(7)
    a, b = (rng.normal(0, 1, (B, 3, H, W)).astype(np.float32) for _ in range(2))
    b[0, 0, 0, :4] = a[0, 0, 0, :4]  # ties
    ta = torch.from_numpy(a).requires_grad_()
    got = l1_loss(ta, torch.from_numpy(b))
    _close(float(got.detach()), float(jax_photometric.l1_loss(jnp.asarray(a), jnp.asarray(b))))
    (grad,) = torch.autograd.grad(got, ta)
    ref_grad = jax.grad(jax_photometric.l1_loss)(jnp.asarray(a), jnp.asarray(b))
    _close(grad, ref_grad)


@pytest.mark.parametrize("mode,smooth_on", [("mean", "depth"), ("ssim", "disp"),
                                            ("min", "disp")])
def test_losses_object_matches_jax(mode, smooth_on):
    rng = _rng(8)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([np.sin(xx * 0.3 + c) * np.cos(yy * 0.2 - c) for c in range(3)], -1)
    frames = [(base + rng.normal(0, 0.05, (B, H, W, 3))).astype(np.float32) for _ in range(3)]
    disps = [[rng.uniform(0.05, 0.9, (B, H, W, 1)).astype(np.float32)] for _ in range(2)]
    poses = np.concatenate([rng.normal(0, 0.01, (B, 2, 3)), rng.normal(0, 0.1, (B, 2, 3))],
                           -1).astype(np.float32)
    settings = dict(mode=mode, smooth_on=smooth_on, smooth_weight=0.5)
    ref = jax_total.Losses(**settings)(
        jnp.asarray(frames[0]), [jnp.asarray(f) for f in frames[1:]],
        [[jnp.asarray(d) for d in f] for f in disps], jnp.asarray(poses), jnp.asarray(K))

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))

    losses = Losses(**settings)
    got = losses(nchw(frames[0]), [nchw(f) for f in frames[1:]],
                 [[nchw(d) for d in f] for f in disps], torch.from_numpy(poses),
                 torch.from_numpy(K))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)


def test_register_model_adds_a_buildable_model():
    class Tiny(torch.nn.Module):
        def __init__(self, width=4):
            super().__init__()
            self.fc = torch.nn.Linear(2, width)

        def reset_parameters(self, generator):
            with torch.no_grad():
                self.fc.weight.copy_(torch.randn(self.fc.weight.shape, generator=generator))

    try:
        assert registry.register_model("TinyForTest")(Tiny) is Tiny
        model = registry.build_model("TinyForTest", torch.Generator().manual_seed(0),
                                     device="cpu", width=3)
        again = registry.build_model("TinyForTest", torch.Generator().manual_seed(0),
                                     device="cpu", width=3)
        assert isinstance(model, Tiny) and model.fc.out_features == 3
        assert torch.equal(model.fc.weight, again.fc.weight)
    finally:
        registry.MODEL_REGISTRY.pop("TinyForTest", None)
    # every name of JAX's registry builds, seeded, on the CPU
    jax_registry.build_model("PoseNet")  # fills JAX's registry
    assert sorted(registry.MODEL_REGISTRY) == sorted(jax_registry.MODEL_REGISTRY)
    for name in jax_registry.MODEL_REGISTRY:
        model = registry.build_model(name, torch.Generator().manual_seed(0), device="cpu",
                                     image_shape=(64, 96))
        assert type(model).__name__ == name
    with pytest.raises(KeyError, match="Registered models"):
        registry.build_model("NoSuchNet", device="cpu")


# the JAX __init__s' names that the port does not have, each with its reason
NOT_IN_PORT = {
    "ops": {"band_coverage", "grid_sample_mxu"},  # the TPU's banded warp
}


@pytest.mark.parametrize("package", ["data", "eval", "geometry", "losses", "models", "ops",
                                     "parallel", "pseudolidar", "train", "utils",
                                     "models.depth", "models.pose"])
def test_each_package_exports_what_jax_exports(package):
    ref = importlib.import_module(f"unsupervised_pseuso_lidar_tpu.{package}")
    ours = importlib.import_module(f"unsupervised_pseuso_lidar_tpu_torch.{package}")
    want = set(ref.__all__) - NOT_IN_PORT.get(package, set())
    assert set(ours.__all__) == want
    for name in ours.__all__:
        assert getattr(ours, name) is not None, name
    assert "jax" not in {m.__name__.split(".")[0] for m in vars(ours).values()
                         if isinstance(m, type(sys))}
