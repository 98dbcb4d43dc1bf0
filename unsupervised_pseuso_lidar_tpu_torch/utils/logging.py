"""Metric logging: JSON lines on stdout always, wandb behind the MLOps flag.

Counterpart of unsupervised_pseuso_lidar_tpu/utils/logging.py
(MetricLogger :15-37). wandb is optional: it runs only when
`action.MLOps` is on and `import wandb` succeeds. Image logging and the
parameter histograms come with utils/visualization.
"""

from __future__ import annotations

import json
import time
from typing import Dict


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
