"""Warp and depth pictures for watching training.

Counterpart of unsupervised_pseuso_lidar_tpu/utils/visualization.py
(depth_to_image :20, image_to_uint8 :36, save_warp_visualization :44):
numpy colouring and PIL PNGs, without matplotlib, byte for byte the JAX
package's. Images here are HWC numpy arrays, as PIL writes them; the
trainer moves a sample off the card and to HWC before it calls these.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import unnormalize_image


def depth_to_image(depth: np.ndarray, max_percentile: float = 95.0) -> np.ndarray:
    """Depth map [H, W] -> uint8 [H, W, 3]: inverse depth scaled by its
    `max_percentile` percentile, through a 3-stop colormap (dark blue ->
    yellow -> red)."""
    inv = 1.0 / np.maximum(np.asarray(depth, dtype=np.float32), 1e-6)
    hi = np.percentile(inv, max_percentile)
    x = np.clip(inv / max(hi, 1e-6), 0.0, 1.0)
    r = np.clip(2.0 * x, 0, 1)
    g = np.clip(2.0 * x - 0.5, 0, 1) * (x < 0.75) + np.clip(4 * (1 - x), 0, 1) * (
        x >= 0.75
    )
    b = np.clip(1.0 - 2.0 * x, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def image_to_uint8(img: np.ndarray, normalized: bool = True) -> np.ndarray:
    """HWC float image (ImageNet-normalized when `normalized`) -> uint8."""
    img = np.asarray(img, dtype=np.float32)
    if normalized:
        img = unnormalize_image(img)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_warp_visualization(
    out_dir: str,
    step: int,
    tgt: np.ndarray,
    warped: np.ndarray,
    depth: np.ndarray,
    normalized: bool = True,
) -> Dict[str, str]:
    """Write out_dir/warping/tgt_<step>.png, warping/warp_<step>.png and
    depth/depth_<step>.png for one sample (tgt, warped [H, W, 3]; depth
    [H, W]); returns {file name: path}."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "warping"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    pairs = {
        os.path.join(out_dir, "warping", f"tgt_{step:06d}.png"): image_to_uint8(
            tgt, normalized),
        os.path.join(out_dir, "warping", f"warp_{step:06d}.png"): image_to_uint8(
            warped, normalized),
        os.path.join(out_dir, "depth", f"depth_{step:06d}.png"): depth_to_image(depth),
    }
    paths = {}
    for path, arr in pairs.items():
        Image.fromarray(arr).save(path)
        paths[os.path.basename(path)] = path
    return paths
