"""Synthetic KITTI-like frames and triplets, made on the device from a seed.

A copy of the program's data/synthetic.py scene (a procedurally textured
fronto-parallel plane seen by a camera translating along x, so ref0 and
ref1 are exact pixel shifts of the target), computed with torch on the
device so that set-up stays short. Its texture phases are drawn exactly as
the original draws them, from numpy's default_rng(seed) of each batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _texture(u: torch.Tensor, v: torch.Tensor, phases: np.ndarray) -> torch.Tensor:
    """Smooth multiscale texture in [0, 1], [H, W, 3]."""
    img = torch.zeros((*u.shape, 3), dtype=torch.float32, device=u.device)
    for k, (fu, fv, pu, pv) in enumerate(phases.tolist()):
        img[..., k % 3] += torch.sin(u * fu + pu) * torch.cos(v * fv + pv)
    img -= img.min()
    img /= torch.clamp(img.max(), min=1e-6)
    return img


def triplet_batch(batch: int, height: int, width: int, seed: int, device,
                  depth: float = 10.0, tx: float = 0.3, focal: float = 100.0
                  ) -> Dict[str, torch.Tensor]:
    """{tgt [B, H, W, 3] uint8, ref_imgs [B, 2, H, W, 3] uint8, intrinsics
    [B, 3, 3]} on `device`: the program's synthetic batch with uint8 images
    (its SyntheticTripletDataset(uint8_images=True))."""
    rng = np.random.default_rng(seed)
    cx, cy = width / 2.0, height / 2.0
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    tgt, refs = [], []
    for _ in range(batch):
        phases = np.stack([rng.uniform(0.02, 0.3, 6), rng.uniform(0.02, 0.3, 6),
                           rng.uniform(0, 2 * np.pi, 6), rng.uniform(0, 2 * np.pi, 6)],
                          axis=-1)
        views = [_texture(u + cam_tx * focal / depth, v, phases) for cam_tx in (0.0, -tx, tx)]
        views = [(view * 255).to(torch.uint8) for view in views]
        tgt.append(views[0])
        refs.append(torch.stack(views[1:]))
    k = torch.tensor([[focal, 0, cx], [0, focal, cy], [0, 0, 1]], dtype=torch.float32,
                     device=device)
    return {"tgt": torch.stack(tgt), "ref_imgs": torch.stack(refs),
            "intrinsics": k.expand(batch, 3, 3).contiguous()}


def frames(count: int, height: int, width: int, seed: int, device) -> np.ndarray:
    """`count` decoded camera frames [N, H, W, 3], ImageNet-normalized
    float32 on the host, as the serving pipeline takes them: the target
    views of the synthetic scene."""
    out = triplet_batch(count, height, width, seed, device)["tgt"].float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=out.device)
    std = torch.tensor(IMAGENET_STD, device=out.device)
    return ((out - mean) / std).cpu().numpy()


def batch_seed(seed: int, index: int) -> int:
    """The seed of batch `index` of a run seeded `seed`."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])
