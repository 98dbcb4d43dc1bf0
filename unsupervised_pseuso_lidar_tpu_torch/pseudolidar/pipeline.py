"""Streaming inference: camera frames -> depth -> pseudo-LiDAR cloud.

Counterpart of unsupervised_pseuso_lidar_tpu/pseudolidar/pipeline.py
(FileImageSource :41, DepthToPointCloudPipeline :77, _stream :125, run
:167, run_multi :181). Frames come in as HWC float numpy images
(ImageNet-normalized, like the JAX pipeline's); the depth function and the
projector run as one module (pseudolidar/export.make_depth_cloud_fn) on
the pipeline's device, and results come back as numpy.

The streaming loop is the reference ROS graph's in one process: a feed
thread pushes the source's frames through a bounded latest-wins queue (at
queue_size 1, the ROS nodes' queue_size=1: a stale frame is dropped when a
fresh one arrives) to the consumer, which runs the program.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.export import make_depth_cloud_fn
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import PseudoLiDAR
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
from unsupervised_pseuso_lidar_tpu_torch.utils.transforms import load_image


class FileImageSource:
    """Replays the PNGs of a directory in name order (a mock camera, as the
    reference's mock_publisher), optionally at `rate_hz` frames a second
    on a fixed time.monotonic schedule; frames as load_image gives them."""

    def __init__(self, image_dir: str, rate_hz: Optional[float] = None,
                 size_hw: Optional[Tuple[int, int]] = None,
                 normalize: bool = True):
        self.paths = sorted(glob.glob(os.path.join(image_dir, "*.png")))
        if not self.paths:
            raise FileNotFoundError(f"No PNGs under {image_dir}")
        self.rate_hz = rate_hz
        self.size_hw = size_hw
        self.normalize = normalize

    def __iter__(self) -> Iterator[np.ndarray]:
        period = 1.0 / self.rate_hz if self.rate_hz else 0.0
        next_t = time.monotonic()
        for path in self.paths:
            img, _, _ = load_image(path, self.size_hw, normalize=self.normalize)
            if period:
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            yield img


@dataclass
class PipelineResult:
    frame_index: int
    depth: np.ndarray          # [H, W] meters
    points: np.ndarray         # [N, 4] velodyne-frame pseudo-LiDAR cloud
    stream_index: int = 0      # camera index on a multi-camera rig


class DepthToPointCloudPipeline:
    """Depth function + pseudo-LiDAR projector on one device.

    Args:
      depth_fn: [B, H, W, 3] tensor on `device` -> [B, H, W] depth (e.g.
        export.make_depth_fn, or a loaded exported program's module()).
      projector: a PseudoLiDAR bound to the same device.
    """

    def __init__(self, depth_fn: Callable, projector: PseudoLiDAR,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if projector.device != self.device:
            raise ValueError(
                f"projector is on {projector.device}, pipeline on {self.device}"
            )
        self.projector = projector
        self._fused = make_depth_cloud_fn(depth_fn, projector)

    @torch.no_grad()
    def _run(self, imgs: np.ndarray):
        x = torch.as_tensor(imgs, dtype=torch.float32).to(self.device)
        depth, points, valid = self._fused(x)
        return depth.cpu().numpy(), points.cpu().numpy(), valid.cpu().numpy()

    def process(self, img: np.ndarray, frame_index: int = 0) -> PipelineResult:
        """One [H, W, 3] frame -> depth + compacted cloud."""
        depth, points, valid = self._run(img[None])
        return PipelineResult(frame_index, depth[0], points[0][valid[0]])

    def process_batch(self, imgs: np.ndarray, frame_index: int = 0):
        """Multi-camera step: [S, H, W, 3] synchronized frames in one
        forward -> one PipelineResult per stream."""
        depth, points, valid = self._run(imgs)
        return [
            PipelineResult(frame_index, depth[s], points[s][valid[s]],
                           stream_index=s)
            for s in range(depth.shape[0])
        ]

    def _stream(self, payloads, handle: Callable[[int, np.ndarray], None],
                queue_size: int) -> int:
        """The streaming loop: a feed thread pushes the enumerated payloads
        through a bounded latest-wins queue into `handle`; returns the
        payloads handled. A source that raises still ends the loop (the
        sentinel is always enqueued) and its exception re-raises here."""
        q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        sentinel = object()
        failure: list = []

        def feed():
            try:
                for item in enumerate(payloads):
                    try:
                        q.put_nowait(item)
                    except queue.Full:
                        try:  # drop the stale payload, keep the fresh one
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
            index, payload = item
            handle(index, payload)
            processed += 1

    def run(self, source: Iterator[np.ndarray],
            on_result: Callable[[PipelineResult], None],
            queue_size: int = 1) -> int:
        """Stream frames through the pipeline; returns frames processed."""
        return self._stream(source, lambda i, frame: on_result(self.process(frame, i)),
                            queue_size)

    def run_multi(self, sources, on_result: Callable[[PipelineResult], None],
                  queue_size: int = 1) -> int:
        """Stream a multi-camera rig: the sources in lockstep, each rig
        step one process_batch; `on_result` fires once per camera a step
        (PipelineResult.stream_index names it). Returns rig steps
        processed; stops at the shortest source (a rig step needs every
        camera)."""
        def handle(i, frames):
            for result in self.process_batch(frames, i):
                on_result(result)

        return self._stream((np.stack(frames) for frames in zip(*sources)), handle,
                            queue_size)
