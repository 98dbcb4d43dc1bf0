"""Training augmentations on the device, consistent across the triplet.

Counterpart of unsupervised_pseuso_lidar_tpu/data/augment.py (color_jitter
:25, horizontal_flip :55, augment_batch :85). They run inside the train
step, on the ImageNet-normalized NCHW images.

The photometric loss compares warped reference pixels with target pixels,
so a colour transform is the SAME for the three frames of a triplet: one
brightness offset and one contrast scale a sample, broadcast over (tgt,
ref0, ref1). A horizontal flip flips all three frames, mirrors the
principal point (cx' = W - 1 - cx), and flips the sparse ground truth and
mirrors the OXTS poses with the same decisions.

The random draws are the port's own stream, not JAX's: `draw_params`
takes them from a CPU torch.Generator seeded from (seed, step), so the
card and the CPU apply the same parameters and a resumed run draws what
the uninterrupted run would have drawn. The transforms take the drawn
parameters explicitly, which is how the tests hold them to JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.utils.device import constant

# the JAX package's ranges: brightness offsets in [-0.2, 0.2), contrast
# scales in [0.8, 1.2), a flip with probability 0.5
BRIGHTNESS, CONTRAST, FLIP_PROB = 0.2, 0.2, 0.5
# conjugation by the mirror M = diag(-1, 1, 1): axis-angle v -> (vx, -vy,
# -vz), translation t -> (-tx, ty, tz)
_OXTS_MIRROR = (1.0, -1.0, -1.0, -1.0, 1.0, 1.0)


@dataclass
class AugmentParams:
    """Per-sample parameters of one step: brightness offsets, contrast
    scales ([B] float32) and flip decisions ([B] bool)."""

    add: torch.Tensor
    scale: torch.Tensor
    flip: torch.Tensor


def draw_params(batch_size: int, seed: int, step: int) -> AugmentParams:
    """The parameters of step `step` on the CPU, from a generator seeded
    by (seed, step)."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state) & ((1 << 63) - 1))
    flip = torch.rand(batch_size, generator=gen) < FLIP_PROB
    add = (torch.rand(batch_size, generator=gen) * 2.0 - 1.0) * BRIGHTNESS
    scale = 1.0 - CONTRAST + torch.rand(batch_size, generator=gen) * (2.0 * CONTRAST)
    return AugmentParams(add, scale, flip)


def color_jitter(
    tgt: torch.Tensor, refs: torch.Tensor, add: torch.Tensor, scale: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x · scale + add per sample, the same for the triplet.

    Args:
      tgt: [B, 3, H, W]; refs: [B, 2, 3, H, W] (float); add, scale: [B].
    """
    s, a = scale[:, None, None, None], add[:, None, None, None]
    return tgt * s + a, refs * s[:, None] + a[:, None]


def horizontal_flip(
    tgt: torch.Tensor, refs: torch.Tensor, intrinsics: torch.Tensor, flip: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flip the samples where `flip` [B] is set: the three frames along the
    width, and cx -> (W - 1) - cx."""
    width = tgt.shape[-1]
    f = flip[:, None, None, None]
    tgt = torch.where(f, tgt.flip(-1), tgt)
    refs = torch.where(f[:, None], refs.flip(-1), refs)
    cx = intrinsics[:, 0, 2]
    intrinsics = intrinsics.clone()
    intrinsics[:, 0, 2] = torch.where(flip, (width - 1) - cx, cx)
    return tgt, refs, intrinsics


def augment_batch(
    batch: Dict[str, torch.Tensor],
    params: AugmentParams,
    jitter: bool = True,
    flip: bool = False,
) -> Dict[str, torch.Tensor]:
    """Apply the enabled augmentations to a normalized NCHW batch; with
    `flip`, groundtruth [B, H, W] is flipped and oxts [B, 2, 6] mirrored
    with the same decisions."""
    device = batch["tgt"].device
    flips = params.flip.to(device)
    out = dict(batch)
    tgt, refs = batch["tgt"], batch["ref_imgs"]
    if flip:
        tgt, refs, out["intrinsics"] = horizontal_flip(tgt, refs, batch["intrinsics"], flips)
        if "groundtruth" in batch:
            gt = batch["groundtruth"]
            out["groundtruth"] = torch.where(flips[:, None, None], gt.flip(-1), gt)
        if "oxts" in batch:
            oxts = batch["oxts"]
            mirror = constant(_OXTS_MIRROR, oxts.dtype, device)
            out["oxts"] = torch.where(flips[:, None, None], oxts * mirror, oxts)
    if jitter:
        tgt, refs = color_jitter(tgt, refs, params.add.to(device), params.scale.to(device))
    out["tgt"], out["ref_imgs"] = tgt, refs
    return out
