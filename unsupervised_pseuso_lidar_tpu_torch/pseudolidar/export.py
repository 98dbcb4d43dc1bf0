"""Serving export: the depth model, optionally fused with the pseudo-LiDAR
projector, as a `torch.export` program.

Counterpart of unsupervised_pseuso_lidar_tpu/pseudolidar/export.py
(batch_poly_spec :48, export_program :77, load_exported :128,
make_depth_fn :137, make_depth_cloud_fn :179, run_exported :209). JAX
writes a `jax.export` StableHLO artifact; the port writes a
`torch.export.ExportedProgram` with `torch.export.save`: one `.pt2`
archive holding the graph and the weights, which `torch.export.load` runs
without the model's classes or a checkpoint format.

- A program takes [B, H, W, 3] ImageNet-normalized float32 images, as
  JAX's does, and returns depth [B, H, W] in meters (fused: also points
  [B, H·W, 4] and valid [B, H·W]).
- Batch polymorphism: one `torch.export.Dim` on the leading axis of every
  input, in place of JAX's symbolic shape. torch.export specializes an
  example dimension of 0 or 1, so a polymorphic program is traced at an
  example batch of at least 2; it then runs at every batch from 1 to
  MAX_BATCH.
- A program is bound to the device it was traced on: its weights live
  there and the projector's pixel grid is built on the depth's device. The
  sidecar records that device; run_exported runs the program there and
  refuses any other.
- precision 'bf16' runs the depth model under bf16 autocast (its weight
  cache off), captured in the graph; the weights stay fp32.

Artifact layout: `<path>` is the `.pt2` archive; `<path>.json` is a
sidecar (input and output shapes and dtypes, device, torch version, size,
user metadata) for tools that inventory artifacts without loading them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import (
    disp_to_depth,
    disp_to_depth_ranged,
)
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import depth_to_pointcloud
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device

FORMAT = "torch.export.ExportedProgram"
BATCH_DIM = "b"
# the symbolic batch's bound: CUDA ops of the fp32 depth model guard the
# batch at 2^16 - 1 (a grid dimension's limit; measured with torch 2.11),
# and a program must declare every guard its trace made
MAX_BATCH = 65535


class DepthProgram(nn.Module):
    """[B, H, W, 3] normalized images -> [B, H, W] fp32 depth in meters
    through an eval-mode depth model (see make_depth_fn)."""

    def __init__(self, depth_model: nn.Module, min_depth: Optional[float] = None,
                 max_depth: Optional[float] = None, precision: str = "fp32",
                 metric_output: bool = False):
        super().__init__()
        if precision not in ("fp32", "bf16"):
            raise ValueError("precision must be 'fp32' or 'bf16'")
        self.model = depth_model
        self.min_depth, self.max_depth, self.precision = min_depth, max_depth, precision
        self.metric_output = metric_output
        self.eval()

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2).contiguous()
        # no weight cache: it is freed on leaving the region, which a CUDA
        # graph of the forward would read after (pseudolidar/pipeline.py)
        with torch.autocast(x.device.type, torch.bfloat16,
                            enabled=self.precision == "bf16", cache_enabled=False):
            outputs = self.model(x)
        if self.metric_output:
            return outputs[-1][:, 0].float()
        disp = outputs[0][:, 0].float()
        if self.min_depth is not None:
            return disp_to_depth_ranged(disp, self.min_depth, self.max_depth or 100.0)[1]
        return disp_to_depth(disp)


class DepthCloudProgram(nn.Module):
    """[B, H, W, 3] image -> (depth [B, H, W], points [B, H·W, 4], valid
    [B, H·W]): a depth function and the projector's backprojection as one
    program (see make_depth_cloud_fn)."""

    def __init__(self, depth_fn: Callable[[torch.Tensor], torch.Tensor], projector):
        super().__init__()
        self.depth_fn = depth_fn
        self.register_buffer("proj", projector.proj.clone())
        self.register_buffer("velo_to_cam", projector.velo_to_cam.clone())
        self.sparsity, self.max_high = projector.sparsity, projector.max_high

    def forward(self, img: torch.Tensor):
        depth = self.depth_fn(img)
        points, valid = depth_to_pointcloud(depth.float(), self.proj, self.velo_to_cam,
                                            sparsity=self.sparsity, max_high=self.max_high)
        return depth, points, valid


def make_depth_fn(depth_model: nn.Module, *, metric_output: bool = False,
                  min_depth: Optional[float] = None, max_depth: Optional[float] = None,
                  precision: str = "fp32") -> DepthProgram:
    """The depth model as a [B, H, W, 3] -> [B, H, W] depth module, its
    weights as state: finest-scale disparity -> depth through
    disp_to_depth, or the monodepth2 range mapping when min_depth is given
    (max_depth defaults to 100 m), or with metric_output the model's last
    output taken as depth in meters as it is (BtsModel's final depth).
    Puts the model in eval mode."""
    return DepthProgram(depth_model, min_depth, max_depth, precision, metric_output)


def make_depth_cloud_fn(depth_fn: Callable[[torch.Tensor], torch.Tensor],
                        projector) -> DepthCloudProgram:
    """Depth inference and pseudo-LiDAR backprojection fused into one
    module: [B, H, W, 3] -> (depth, points, valid), no host round trip
    between depth and cloud. The projector's calibration becomes buffers."""
    return DepthCloudProgram(depth_fn, projector)


def _device(device: torch.device) -> torch.device:
    """`device` with the current CUDA index filled in ("cuda" -> "cuda:0")."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _describe(nodes) -> list:
    return [{"shape": [str(d) if isinstance(d, int) else BATCH_DIM
                       for d in node.meta["val"].shape],
             "dtype": str(node.meta["val"].dtype).removeprefix("torch.")}
            for node in nodes]


def export_program(
    fn: nn.Module,
    example: Sequence[torch.Tensor],
    path: str,
    *,
    batch_poly: bool = False,
    metadata: Optional[Dict[str, Any]] = None,
) -> torch.export.ExportedProgram:
    """Trace `fn(*example)` with torch.export and save it to `path` (+ the
    `.json` sidecar), on the examples' device.

    Args:
      fn: an nn.Module; its parameters and buffers become the program's
        state.
      example: one tensor per positional input, on the device the program
        is for.
      batch_poly: a symbolic leading (batch) axis shared by every input;
        the examples' batch must then be at least 2.
      metadata: extra JSON-serializable sidecar fields. The fields that
        describe the artifact (format, torch_version, device, inputs,
        outputs, size_bytes) always win over them.
    Returns:
      the ExportedProgram (already written to disk).
    """
    example = tuple(example)
    dynamic_shapes = None
    if batch_poly:
        if min(t.shape[0] for t in example) < 2:
            raise ValueError("a batch-polymorphic program is traced at an example batch "
                             ">= 2 (torch.export specializes a dimension of 1)")
        batch = torch.export.Dim(BATCH_DIM, min=1, max=MAX_BATCH)
        dynamic_shapes = tuple({0: batch} for _ in example)
    program = torch.export.export(fn, example, dynamic_shapes=dynamic_shapes)
    # torch.export.save would also store the example inputs (11.8 MB of a
    # batch-2 1280x384 trace, 17 % of the archive); they are not the program
    program.example_inputs = None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)

    signature = program.graph_signature
    inputs = [n for n in program.graph.nodes
              if n.op == "placeholder" and n.name in signature.user_inputs]
    (output,) = [n for n in program.graph.nodes if n.op == "output"]
    outputs = [n for n in output.args[0] if n.name in signature.user_outputs]
    sidecar = {
        **(metadata or {}),
        "format": FORMAT,
        "torch_version": torch.__version__,
        "device": str(_device(example[0].device)),
        "inputs": _describe(inputs),
        "outputs": _describe(outputs),
        "size_bytes": os.path.getsize(path),
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    return program


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load an artifact written by export_program (`.module()` runs it)."""
    return torch.export.load(path)


def run_exported(path: str, *args, device: str | torch.device = "cuda"):
    """Load an artifact and run it once on `device` (default the CUDA
    card), which must be the device it was traced on (its sidecar's).
    numpy inputs are copied there; a tensor on another device raises
    instead of being moved."""
    device = _device(resolve_device(device))
    with open(path + ".json") as f:
        traced_on = torch.device(json.load(f)["device"])
    if traced_on != device:
        raise ValueError(f"{path} was traced on {traced_on} and runs only there, "
                         f"not on {device}")
    inputs = []
    for arg in args:
        if not torch.is_tensor(arg):
            arg = torch.as_tensor(np.asarray(arg), device=device)
        elif _device(arg.device) != device:
            raise ValueError(f"an input is on {arg.device}; {path} runs on {device}")
        inputs.append(arg)
    with torch.no_grad():
        return load_exported(path).module()(*inputs)
