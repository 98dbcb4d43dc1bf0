"""The served depth from a depth net's outputs, as the program's serving
path maps them (a plain copy of its depth function's mapping).

- `metric_output`: the net's last output, channel 0, is depth in metres
  (BtsModel's final depth);
- else its first output is a disparity in (0, 1): with `min_depth` given,
  monodepth2's range mapping to [min_depth, max_depth] (max_depth 100 m
  unless given); without, D = 1 / (10 disp + 0.01).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from portbench.reference.loss import disp_to_depth


def served_depth(outputs: Sequence[torch.Tensor], serving: Dict) -> torch.Tensor:
    """[B, H, W] depth in metres (module docstring)."""
    if serving["metric_output"]:
        return outputs[-1][:, 0]
    disp = outputs[0][:, 0]
    min_depth = serving.get("min_depth")
    if min_depth is None:
        return disp_to_depth(disp)
    max_depth = serving.get("max_depth") or 100.0
    min_disp, max_disp = 1.0 / max_depth, 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)
