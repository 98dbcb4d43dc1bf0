"""Streaming inference: camera frames -> depth -> pseudo-LiDAR cloud.

Counterpart of unsupervised_pseuso_lidar_tpu/pseudolidar/pipeline.py
(DepthToPointCloudPipeline :77-179). Frames come in as HWC float numpy
images (ImageNet-normalized, like the JAX pipeline's); the depth model and
the projector run on the pipeline's device, and results come back as
numpy. FileImageSource (PNG replay) and run_multi are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.geometry.warp import disp_to_depth
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device


@dataclass
class PipelineResult:
    frame_index: int
    depth: np.ndarray          # [H, W] meters
    points: np.ndarray         # [N, 4] velodyne-frame pseudo-LiDAR cloud
    stream_index: int = 0      # camera index on a multi-camera rig


def depth_fn_from_model(
    depth_model: nn.Module, precision: str = "fp32"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """[B, 3, H, W] normalized images -> [B, H, W] fp32 depth in meters
    through an eval-mode depth model; precision 'bf16' runs the model
    under bf16 autocast."""
    depth_model.eval()

    def depth_fn(img: torch.Tensor) -> torch.Tensor:
        with torch.autocast(img.device.type, torch.bfloat16,
                            enabled=precision == "bf16"):
            disp = depth_model(img)[0]
        return disp_to_depth(disp[:, 0].float())

    return depth_fn


class DepthToPointCloudPipeline:
    """Depth model + pseudo-LiDAR projector on one device.

    Args:
      depth_fn: [B, 3, H, W] tensor on `device` -> [B, H, W] depth (e.g.
        depth_fn_from_model).
      projector: a PseudoLiDAR bound to the same device.
    """

    def __init__(self, depth_fn: Callable, projector: PseudoLiDAR,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if projector.device != self.device:
            raise ValueError(
                f"projector is on {projector.device}, pipeline on {self.device}"
            )
        self.depth_fn = depth_fn
        self.projector = projector

    @torch.no_grad()
    def _fused(self, imgs: np.ndarray):
        x = torch.as_tensor(imgs, dtype=torch.float32).permute(0, 3, 1, 2)
        depth = self.depth_fn(x.to(self.device).contiguous())
        points, valid = self.projector.project_batch(depth)
        return depth.cpu().numpy(), points.cpu().numpy(), valid.cpu().numpy()

    def process(self, img: np.ndarray, frame_index: int = 0) -> PipelineResult:
        """One [H, W, 3] frame -> depth + compacted cloud."""
        depth, points, valid = self._fused(img[None])
        return PipelineResult(frame_index, depth[0], points[0][valid[0]])

    def process_batch(self, imgs: np.ndarray, frame_index: int = 0):
        """Multi-camera step: [S, H, W, 3] synchronized frames in one
        forward -> one PipelineResult per stream."""
        depth, points, valid = self._fused(imgs)
        return [
            PipelineResult(frame_index, depth[s], points[s][valid[s]],
                           stream_index=s)
            for s in range(depth.shape[0])
        ]

    def run(self, source: Iterator[np.ndarray],
            on_result: Callable[[PipelineResult], None],
            queue_size: int = 1) -> int:
        """Stream frames through the pipeline; returns frames processed.

        A feed thread pushes the source's frames through a bounded
        latest-wins queue (a stale frame is dropped when a fresh one
        arrives and the queue is full); a source that raises ends the loop
        and re-raises here."""
        q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        sentinel = object()
        failure: list = []

        def feed():
            try:
                for item in enumerate(source):
                    try:
                        q.put_nowait(item)
                    except queue.Full:
                        try:  # drop the stale frame, keep the fresh one
                            q.get_nowait()
                        except queue.Empty:
                            pass
                        q.put(item)
            except BaseException as exc:  # re-raised by the consumer
                failure.append(exc)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=feed, daemon=True)
        thread.start()
        processed = 0
        while True:
            item = q.get()
            if item is sentinel:
                thread.join()
                if failure:
                    raise failure[0]
                return processed
            index, frame = item
            on_result(self.process(frame, index))
            processed += 1
