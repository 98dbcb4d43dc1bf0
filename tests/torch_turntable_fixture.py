"""A stand-in for the dinosaur turntable's data tree, which is in neither
this repo nor its test machines: the examples' tests
(tests/test_torch_examples.py) and chip_smoke.py's `examples` phase write
it to a temporary directory and run the port's
examples/dino_turntable.py on it."""

import os

import numpy as np

from unsupervised_pseuso_lidar_tpu_torch.examples import dino_turntable


def write_synthetic_turntable(root: str, num: int = 36, width: int = 720,
                              height: int = 576, seed: int = 0) -> str:
    """Write a stand-in for the turntable's tree under `root` —
    images/viff.NNN.ppm (`num` frames, width x height) and
    utils/dino_Ps.mat (P, 1 x num cameras K [R | t]) — for checks where
    the real data is absent; returns `root`. It is not the real data: it
    only gives load_dino and the warp a scene whose ground-truth warp
    explains the frames. Camera i sits 10° further round a vertical axis
    (world y) through FRONT_POINT, 0.5 units from it, looking at it; the
    scene is a plane 0.5 units behind the axis (as camera 0 sees it:
    depth ~1, the scale the objective's normalized depth takes), textured
    with smooth seeded sinusoids and rendered exactly through each camera
    by the plane's homography. Pixels whose ray misses the plane (the
    cameras that have turned past it) are grey."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    center = np.array(dino_turntable.FRONT_POINT)
    plane_z = center[2] - 0.5
    # (frequency in x, in y, phase) of 4 sinusoids a channel, in radians a
    # unit of the plane: periods of 0.04 – 0.25 units
    waves = np.stack([rng.uniform(25, 150, (3, 4)), rng.uniform(25, 150, (3, 4)),
                      rng.uniform(0, 2 * np.pi, (3, 4))], -1)
    focal = 1.6 * width
    k = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    u, v = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    pixels = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(k).T
    projections = np.empty((1, num), dtype=object)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "utils"), exist_ok=True)
    for i in range(num):
        angle = 2 * np.pi * i / 36
        eye = center + 0.5 * np.array([np.sin(angle), 0.0, np.cos(angle)])
        z = (center - eye) / np.linalg.norm(center - eye)
        y = np.array([0.0, 1.0, 0.0])
        rot = np.stack([np.cross(y, z), y, z])
        t = -rot @ eye
        projections[0, i] = k @ np.hstack([rot, t[:, None]])
        rays = pixels @ rot  # R^T K^-1 [u, v, 1] for every pixel
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (plane_z - eye[2]) / rays[..., 2]
        hit = np.isfinite(s) & (s > 0)
        s = np.where(hit, s, 0.0)
        px, py = eye[0] + s * rays[..., 0], eye[1] + s * rays[..., 1]
        img = np.zeros((height, width, 3))
        for c in range(3):
            for fx, fy, phase in waves[c]:
                img[..., c] += np.sin(fx * px + phase) * np.cos(fy * py + phase)
        img = np.where(hit[..., None], (img + 4.0) / 8.0, 0.5)
        Image.fromarray(np.round(255 * img).astype(np.uint8)).save(
            os.path.join(root, "images", f"viff.{i:03d}.ppm"))
    savemat(os.path.join(root, "utils", "dino_Ps.mat"), {"P": projections})
    return root
