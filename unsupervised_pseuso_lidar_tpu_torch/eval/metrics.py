"""KITTI depth evaluation metrics.

Counterpart of unsupervised_pseuso_lidar_tpu/eval/metrics.py
(GARG_CROP :25, eigen_crop_mask :28, _per_image_metrics :41,
compute_errors :96): silog, abs_rel, log10, rms, sq_rel (the true squared
relative error), log_rms and the delta thresholds d1/d2/d3, per image over
its valid pixels, then averaged over the images with at least one.

The per-image masked means accumulate in fp64 and are rounded once, so a
metric does not depend on the device's summation order (silog is a
difference of two means).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# Garg/Eigen evaluation crop, fractions of (H, W):
# rows [0.40810811, 0.99189189), cols [0.03594771, 0.96405229).
GARG_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)
METRICS = ("silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms", "d1", "d2", "d3")


def eigen_crop_mask(height: int, width: int,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """[H, W] boolean mask of the Garg crop of the KITTI Eigen-split
    monocular protocol (the fractions of GARG_CROP, truncated to ints)."""
    top = int(GARG_CROP[0] * height)
    bottom = int(GARG_CROP[1] * height)
    left = int(GARG_CROP[2] * width)
    right = int(GARG_CROP[3] * width)
    rows = torch.arange(height, device=device)
    cols = torch.arange(width, device=device)
    return (((rows >= top) & (rows < bottom))[:, None]
            & ((cols >= left) & (cols < right))[None, :])


def _nanmedian(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B]: the median of each row's valid entries, the mean of
    the two middle ones at an even count (jnp.nanmedian's linear
    interpolation; torch.median takes the lower one); NaN for a row with
    none."""
    count = valid.sum(dim=1)
    ordered = torch.sort(torch.where(valid, x, torch.inf), dim=1).values
    lo = ordered.gather(1, (torch.clamp(count - 1, min=0) // 2)[:, None])[:, 0]
    hi = ordered.gather(1, torch.clamp(count // 2, max=x.shape[1] - 1)[:, None])[:, 0]
    return torch.where(count > 0, 0.5 * lo + 0.5 * hi, torch.nan)


def _per_image_metrics(
    gt: torch.Tensor,
    pred: torch.Tensor,
    mask: torch.Tensor,
    min_depth: float,
    max_depth: float,
    median_scale: bool,
):
    """Metrics of each row of [B, N] -> ({name: [B]}, n_valid [B])."""
    if median_scale:
        scale = _nanmedian(gt, mask) / torch.clamp(_nanmedian(pred, mask), min=1e-9)
        scale = torch.where(torch.isfinite(scale), scale, 1.0)
        pred = pred * scale[:, None]
    pred = torch.clamp(pred, min_depth, max_depth)
    maskf = mask.double()
    n_valid = maskf.sum(dim=1)
    n = torch.clamp(n_valid, min=1.0)
    safe_gt = torch.where(mask, gt, 1.0)

    def masked_mean(x):
        return (x.double() * maskf).sum(dim=1) / n

    thresh = torch.maximum(safe_gt / pred, pred / safe_gt)
    err = torch.log(pred) - torch.log(safe_gt)
    metrics = {
        "silog": torch.sqrt(torch.clamp(
            masked_mean(err ** 2) - masked_mean(err) ** 2, min=0.0)) * 100.0,
        "abs_rel": masked_mean(torch.abs(safe_gt - pred) / safe_gt),
        "log10": masked_mean(torch.abs(torch.log10(pred) - torch.log10(safe_gt))),
        "rms": torch.sqrt(masked_mean((safe_gt - pred) ** 2)),
        "sq_rel": masked_mean((safe_gt - pred) ** 2 / safe_gt),
        "log_rms": torch.sqrt(masked_mean(err ** 2)),
        "d1": masked_mean((thresh < 1.25).float()),
        "d2": masked_mean((thresh < 1.25 ** 2).float()),
        "d3": masked_mean((thresh < 1.25 ** 3).float()),
    }
    return {k: v.float() for k, v in metrics.items()}, n_valid


def compute_errors(
    gt: torch.Tensor,
    pred: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    median_scale: bool = False,
) -> Dict[str, torch.Tensor]:
    """Depth error metrics over valid ground-truth pixels -> {name: 0-dim
    tensor}.

    Args:
      gt, pred: depth, [H, W] (one image) or [B, H, W] (any trailing dims).
      mask: optional boolean validity mask (ANDed with gt > 0); default
        (gt > min_depth) & (gt < max_depth).
      min_depth/max_depth: predictions are clipped to this range.
      median_scale: multiply each image's pred by median(gt)/median(pred)
        over its valid pixels (1 where that ratio is not finite) — the
        monocular protocol for a scale-ambiguous model.
    Metrics are per image, then the mean over the images with at least one
    valid pixel.
    """
    gt = gt.float()
    pred = pred.float()
    if mask is None:
        mask = (gt > min_depth) & (gt < max_depth)
    else:
        mask = torch.broadcast_to(mask, gt.shape) & (gt > 0)
    batch = 1 if gt.ndim <= 2 else gt.shape[0]
    metrics, n_valid = _per_image_metrics(
        gt.reshape(batch, -1), pred.reshape(batch, -1), mask.reshape(batch, -1),
        min_depth, max_depth, median_scale,
    )
    if gt.ndim <= 2:
        return {k: v[0] for k, v in metrics.items()}
    has_valid = (n_valid > 0).float()
    denom = torch.clamp(has_valid.sum(), min=1.0)
    return {k: (v * has_valid).sum() / denom for k, v in metrics.items()}
