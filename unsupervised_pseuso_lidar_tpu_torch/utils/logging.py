"""Metric logging: JSON lines on stdout always, wandb behind the MLOps flag.

Counterpart of unsupervised_pseuso_lidar_tpu/utils/logging.py
(MetricLogger :15-37, log_images :39, log_param_histograms :51). wandb is
optional: it runs only when `action.MLOps` is on and `import wandb`
succeeds; without it the image and histogram calls do nothing.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Mapping

from torch import nn


class MetricLogger:
    """Callable(metrics: dict, step: int) logger."""

    def __init__(self, config=None, project: str = "unsup-depth-estimation"):
        self._wandb = None
        self._start = time.time()
        if config is not None and config.action.mlops:
            try:
                import wandb

                wandb.init(project=project, config=config.to_dict())
                self._wandb = wandb
            except Exception as exc:  # wandb absent, or offline
                print(f"[logging] wandb unavailable ({exc}); stdout only")

    def __call__(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, "t": round(time.time() - self._start, 1)}
        record.update({k: round(float(v), 6) for k, v in metrics.items()})
        print(json.dumps(record), flush=True)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, images: Dict[str, str], step: int) -> None:
        """Log rendered images (name -> PNG path or HWC array). No-op
        without wandb."""
        if self._wandb is None:
            return
        self._wandb.log({name: self._wandb.Image(img) for name, img in images.items()},
                        step=step)

    def log_param_histograms(self, models: Mapping[str, nn.Module], step: int) -> None:
        """One weight histogram a parameter tensor, keyed
        params/<net>/<parameter name with '.' -> '/'> (nets: {"depth": ...,
        "pose": ...}), wandb.watch's view of the weights. No-op without
        wandb."""
        if self._wandb is None:
            return
        hists = {
            f"params/{net}/" + name.replace(".", "/"):
                self._wandb.Histogram(param.detach().float().cpu().numpy().ravel())
            for net, model in models.items()
            for name, param in model.named_parameters()
        }
        self._wandb.log(hists, step=step)
