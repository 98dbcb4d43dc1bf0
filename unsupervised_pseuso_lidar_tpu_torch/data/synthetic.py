"""Synthetic KITTI-like triplet generator with known geometry (numpy).

Counterpart of unsupervised_pseuso_lidar_tpu/data/synthetic.py, copied so
the port never imports the JAX package: the same seeds give the same
batches in both packages, which is what the parity tests rely on.

A procedurally-textured plane observed by a translating camera, so that

  * the photometric warp has an exact closed-form inverse (a pure pixel
    shift of fx*tx/depth), and
  * ground-truth depth and ground-truth poses are known exactly.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _texture(u: np.ndarray, v: np.ndarray, phases: np.ndarray) -> np.ndarray:
    """Smooth multiscale texture in [0, 1]; u, v in pixels, phases [K, 4]."""
    img = np.zeros((*u.shape, 3), dtype=np.float32)
    for k, (fu, fv, pu, pv) in enumerate(phases):
        channel = k % 3
        img[..., channel] += np.sin(u * fu + pu) * np.cos(v * fv + pv)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img.astype(np.float32)


def synthetic_triplet_batch(
    batch_size: int,
    height: int,
    width: int,
    seed: int = 0,
    depth: float = 10.0,
    tx: float = 0.3,
    focal: float = 100.0,
    slant_deg: float = 0.0,
    occluder: str | None = None,
    occ_depth: float = 5.0,
) -> Dict[str, np.ndarray]:
    """One batch of (tgt, refs, intrinsics, oxts, groundtruth).

    The camera translates along +x by -tx (to ref0) and +tx (to ref1).
    The scene is a textured plane through (0, 0, depth); with
    slant_deg=0 it is fronto-parallel (ref images are exact pixel shifts
    of the target by ±focal*tx/depth). With slant_deg != 0 the plane is
    tilted about the vertical axis (normal (-sin a, 0, cos a)) and all
    three views are rendered by exact ray-plane intersection, so the
    ground-truth depth VARIES across the image — tests and benchmarks
    that median-scale their metrics need this, since on a constant-depth
    scene any constant prediction median-scales to a perfect score.

    `occluder` composites a textured square patch at `occ_depth` (nearer
    than the background) over the scene, producing the two pathologies
    the monodepth2-family objective exists for:

      * "static": the patch is a fixed world-space object — it parallax-
        shifts between views, so background pixels next to it are
        occluded in one reference view and visible in the other
        (per-pixel MIN over refs should pick the visible one);
      * "camera_locked": the patch sits at the SAME pixels in all three
        views (an object moving exactly with the camera) — no geometry
        explains it, and its identity (unwarped) error is zero, the
        precise case binary automasking removes.

    With an occluder the returned dict gains "occ_mask" [B, H, W]: True
    where the target view shows the patch.
    """
    rng = np.random.default_rng(seed)
    cx, cy = width / 2.0, height / 2.0
    tan_a = float(np.tan(np.radians(slant_deg)))

    vv, uu = np.meshgrid(
        np.arange(height, dtype=np.float32),
        np.arange(width, dtype=np.float32),
        indexing="ij",
    )
    # normalized ray directions (z = 1)
    dx = (uu - cx) / focal
    dy = (vv - cy) / focal
    denom = np.maximum(1.0 - tan_a * dx, 1e-3)  # (n·d)/cos(a)

    def surface_coords(cam_tx: float):
        """Texture coordinates seen by the camera at translation (cam_tx,0,0).

        lambda = (c - n·t)/(n·d) with c = depth*cos(a):
        lambda = (depth + tan(a)*cam_tx) / (1 - tan(a)*dx); the plane
        point is X = t + lambda*d, parameterized into texture pixels as
        X*focal/depth + principal point (identical to image pixels for
        the slant-0 target view)."""
        lam = (depth + tan_a * cam_tx) / denom
        su = (cam_tx + lam * dx) * focal / depth + cx
        sv = (lam * dy) * focal / depth + cy
        return su, sv

    tgt = np.zeros((batch_size, height, width, 3), dtype=np.float32)
    refs = np.zeros((batch_size, 2, height, width, 3), dtype=np.float32)
    (tu, tv), (r0u, r0v), (r1u, r1v) = (
        surface_coords(0.0), surface_coords(-tx), surface_coords(tx)
    )

    occ_inside = occ_tex = None
    if occluder is not None:
        if occluder not in ("static", "camera_locked"):
            raise ValueError(f"Unknown occluder kind: {occluder!r}")
        # patch box in world coords on the z = occ_depth plane, sized to
        # cover the central ~quarter of the target view
        u0, u1 = width * 0.40, width * 0.60
        v0, v1 = height * 0.35, height * 0.65
        x0, x1 = (u0 - cx) * occ_depth / focal, (u1 - cx) * occ_depth / focal
        y0, y1 = (v0 - cy) * occ_depth / focal, (v1 - cy) * occ_depth / focal

        def patch_view(cam_tx: float):
            """(inside mask, texture coords) of the patch seen from the
            camera at (cam_tx, 0, 0); camera_locked objects travel with
            the camera, so every view sees the tgt-view projection."""
            if occluder == "camera_locked":
                cam_tx = 0.0
            px = cam_tx + occ_depth * dx  # ray ^ z=occ_depth plane
            py = occ_depth * dy
            inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
            return inside, (px * focal / occ_depth + cx,
                            py * focal / occ_depth + cy)

        occ_views = [patch_view(0.0), patch_view(-tx), patch_view(tx)]
        occ_inside = [v[0] for v in occ_views]
        occ_tex = [v[1] for v in occ_views]

    for b in range(batch_size):
        phases = np.stack(
            [
                rng.uniform(0.02, 0.3, 6),
                rng.uniform(0.02, 0.3, 6),
                rng.uniform(0, 2 * np.pi, 6),
                rng.uniform(0, 2 * np.pi, 6),
            ],
            axis=-1,
        )
        tgt[b] = _texture(tu, tv, phases)
        refs[b, 0] = _texture(r0u, r0v, phases)  # camera at -tx
        refs[b, 1] = _texture(r1u, r1v, phases)  # camera at +tx
        if occluder is not None:
            # higher-frequency independent texture so the patch contrasts
            # with whatever background it covers
            occ_phases = np.stack(
                [
                    rng.uniform(0.35, 0.9, 6),
                    rng.uniform(0.35, 0.9, 6),
                    rng.uniform(0, 2 * np.pi, 6),
                    rng.uniform(0, 2 * np.pi, 6),
                ],
                axis=-1,
            )
            for img, inside, (pu, pv) in zip(
                (tgt[b], refs[b, 0], refs[b, 1]), occ_inside, occ_tex
            ):
                img[inside] = _texture(pu, pv, occ_phases)[inside]

    k = np.array(
        [[focal, 0, cx], [0, focal, cy], [0, 0, 1]],
        dtype=np.float32,
    )
    intrinsics = np.broadcast_to(k, (batch_size, 3, 3)).copy()

    # target->ref 6-DoF ground-truth poses (axis-angle zero, translation):
    # warping ref0 into tgt samples ref0 at u + fx*px/d; ref0[u] = tex(u -
    # s) so the aligning pose has px = -tx ... sign follows the warp math.
    oxts = np.zeros((batch_size, 2, 6), dtype=np.float32)
    oxts[:, 0, 3] = tx
    oxts[:, 1, 3] = -tx

    # target-view depth: Z = lambda (ray dir has z = 1)
    groundtruth = np.broadcast_to(
        (depth / denom).astype(np.float32), (batch_size, height, width)
    ).copy()

    out = {
        "tgt": tgt,
        "ref_imgs": refs,
        "intrinsics": intrinsics,
        "oxts": oxts,
        "groundtruth": groundtruth,
    }
    if occluder is not None:
        groundtruth[:, occ_inside[0]] = occ_depth
        out["occ_mask"] = np.broadcast_to(
            occ_inside[0], (batch_size, height, width)
        ).copy()
    return out


class SyntheticTripletDataset:
    """Iterable dataset of synthetic triplet batches (deterministic per
    seed/epoch) exposing the same batch schema as the KITTI pipeline."""

    def __init__(
        self,
        num_batches: int,
        batch_size: int,
        height: int,
        width: int,
        seed: int = 0,
        depth: float = 10.0,
        tx: float = 0.3,
        uint8_images: bool = False,
    ):
        self.num_batches = num_batches
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.seed = seed
        self.depth = depth
        self.tx = tx
        self.uint8_images = uint8_images

    def __len__(self) -> int:
        return self.num_batches * self.batch_size

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.num_batches):
            batch = synthetic_triplet_batch(
                self.batch_size,
                self.height,
                self.width,
                seed=self.seed + epoch * self.num_batches + i,
                depth=self.depth,
                tx=self.tx,
            )
            if self.uint8_images:
                batch["tgt"] = (batch["tgt"] * 255).astype(np.uint8)
                batch["ref_imgs"] = (batch["ref_imgs"] * 255).astype(np.uint8)
            yield batch
