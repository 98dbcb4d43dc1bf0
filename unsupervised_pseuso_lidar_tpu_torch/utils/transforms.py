"""Host-side image loading and ImageNet normalization (numpy / PIL).

Counterpart of unsupervised_pseuso_lidar_tpu/utils/transforms.py
(load_image :23, load_depth_png :49, load_image_uint8 :70,
load_image_uint8_cached :91, normalize_image :129, unnormalize_image
:134). The loaders decode and resize with PIL exactly as the JAX ones do
— Image.open, then resize(BILINEAR) for frames and resize(NEAREST) for
16-bit depth PNGs — so they return the same bytes: uint8 or float HWC
frames with the original height and width (for the intrinsics rescale),
and depth as uint16 / 256 in meters.
"""

from __future__ import annotations

import hashlib
import os
import threading
import zipfile
from typing import Optional, Tuple
from uuid import uuid4

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def _open_resized(path: str, size_hw: Optional[Tuple[int, int]], resample):
    """(PIL image resized to size_hw when it differs, orig_h, orig_w)."""
    from PIL import Image

    img = Image.open(path)
    orig_w, orig_h = img.size
    if size_hw is not None and (orig_h, orig_w) != size_hw:
        img = img.resize((size_hw[1], size_hw[0]), getattr(Image, resample))
    return img, orig_h, orig_w


def load_image(
    path: str,
    size_hw: Optional[Tuple[int, int]] = None,
    normalize: bool = True,
) -> Tuple[np.ndarray, int, int]:
    """An image -> (float32 HWC in [0, 1], ImageNet-normalized when
    `normalize`; original height; original width), resized bilinearly."""
    img, orig_h, orig_w = _open_resized(path, size_hw, "BILINEAR")
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = arr / 255.0
    if normalize:
        arr = normalize_image(arr)
    return arr, orig_h, orig_w


def load_depth_png(
    path: str, size_hw: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """A KITTI data_depth_annotated PNG (depth · 256 as uint16, 0 = no
    measurement) -> float32 HW depth in meters, resized NEAREST so that
    valid and invalid pixels never mix."""
    img, _, _ = _open_resized(path, size_hw, "NEAREST")
    return np.asarray(img, dtype=np.float32) / 256.0


def load_image_uint8(
    path: str, size_hw: Optional[Tuple[int, int]] = None
) -> Tuple[np.ndarray, int, int]:
    """An image -> (raw uint8 HWC, resized bilinearly, not normalized;
    original height; original width). The training pipeline ships these
    bytes and normalizes on the device: a quarter of fp32's bytes."""
    img, orig_h, orig_w = _open_resized(path, size_hw, "BILINEAR")
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr, orig_h, orig_w


def load_image_uint8_cached(
    path: str,
    size_hw: Optional[Tuple[int, int]],
    cache_dir: str,
) -> Tuple[np.ndarray, int, int]:
    """load_image_uint8 through a disk cache of decoded arrays: the first
    call decodes and writes <cache_dir>/<sha1(path|size)>.npz; later calls
    read it back. An unreadable entry is decoded again and rewritten. Each
    writer publishes through its own temporary file and an atomic rename
    (thread workers share a pid, and neighbouring triplets share frames)."""
    key = hashlib.sha1(
        f"{os.path.abspath(path)}|{size_hw}".encode()
    ).hexdigest()
    cpath = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(cpath):
        try:
            with np.load(cpath) as data:
                return data["img"], int(data["h"]), int(data["w"])
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            pass  # a damaged entry: decode again and rewrite it
    arr, orig_h, orig_w = load_image_uint8(path, size_hw)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = cpath + f".tmp{os.getpid()}-{threading.get_ident()}-{uuid4().hex[:8]}"
    with open(tmp, "wb") as f:
        np.savez(f, img=arr, h=orig_h, w=orig_w)
    os.replace(tmp, cpath)
    return arr, orig_h, orig_w


def normalize_image(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalize a float HWC image in [0, 1]."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def unnormalize_image(img: np.ndarray) -> np.ndarray:
    """Inverse of normalize_image (for visualization)."""
    return img * IMAGENET_STD + IMAGENET_MEAN
