"""Streaming inference: camera frames -> depth -> pseudo-LiDAR cloud.

Counterpart of unsupervised_pseuso_lidar_tpu/pseudolidar/pipeline.py
(FileImageSource :41, DepthToPointCloudPipeline :77, _stream :125, run
:167, run_multi :181). Frames come in as HWC float numpy images
(ImageNet-normalized, like the JAX pipeline's); the depth function and the
projector run as one module (pseudolidar/export.make_depth_cloud_fn) on
the pipeline's device, and results come back as numpy.

JAX jits that module (`self._fused = jax.jit(fused)`) and compacts its
clouds with numpy; on the card the port runs it as CUDA graphs
(train/graph.StepGraphs), one a batch shape: a one-camera stream and a
rig each replay one graph a frame or rig step. `process` and
`process_batch` serve a body that also compacts each camera's cloud on
the device (projector.partition_kept: the kept points first, in pixel
order, and their count), so the host copies depth and the kept rows
alone. A frame is copied into the graph's static input, the graph is
replayed with one launch, the counts are read and depth and the kept
rows are copied to the host. graph=False runs the same body eagerly, one
launch an op.

Under a torch.profiler session a call records its spans
(utils/profiling.annotate): `pseudolidar.frame` around a `process` or
`process_batch` call (its unit id the frame index), and inside it, after
the step graph's own, `pseudolidar.wait` (the host blocked until the
card has the outputs; CUDA only), `pseudolidar.compact` (what compaction
leaves to the host: the kept counts read, each camera's rows chosen) and
`pseudolidar.copy_out` (depth and the kept rows copied to the host).

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
from unsupervised_pseuso_lidar_tpu_torch.pseudolidar.projector import (
    PseudoLiDAR,
    partition_kept,
)
from unsupervised_pseuso_lidar_tpu_torch.train.graph import StepGraphs
from unsupervised_pseuso_lidar_tpu_torch.utils.device import resolve_device
from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import annotate
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
      graph: None runs the program as CUDA graphs where capture applies
        (a CUDA device), else eagerly; False eagerly; True as graphs,
        and a ValueError on the CPU (train/graph.StepGraphs). Per batch
        shape the first call runs eagerly, the second captures, the rest
        replay; the graphs have a memory pool of their own. A capture or
        replay that fails raises: nothing falls back to eager.

    The graphs read the depth model's weights where they lie: weights
    copied in place (load_serving_weights, load_state_dict) are served by
    the next frame; a parameter replaced by another tensor makes the next
    call raise until reset() drops the graphs.

    Counters: `card_compactions`, the camera frames whose cloud was
    compacted on the device, and `kept_points`, their points kept in all.
    """

    def __init__(self, depth_fn: Callable, projector: PseudoLiDAR,
                 device: str | torch.device = "cuda", graph: Optional[bool] = None):
        self.device = resolve_device(device)
        if projector.device != self.device:
            raise ValueError(
                f"projector is on {projector.device}, pipeline on {self.device}"
            )
        self.projector = projector
        self._fused = make_depth_cloud_fn(depth_fn, projector)
        self.graphs = StepGraphs(self.device, graph, modules=[self._fused])
        self.card_compactions = 0
        self.kept_points = 0

    def reset(self) -> None:
        """Drop the graphs: the next frame of each batch shape runs eagerly
        again, the one after captures anew (StepGraphs.reset)."""
        self.graphs.reset()

    @torch.no_grad()
    def _body(self, inputs):
        """(depth, points, valid) of a [B, H, W, 3] float32 batch: what a
        graph of `infer` captures."""
        return self._fused(inputs["img"].to(self.device))

    @torch.no_grad()
    def _compacting_body(self, inputs):
        """(depth [B, H, W], points [B, H·W, 4] each camera's kept points
        first, count [B]) of a [B, H, W, 3] float32 batch: what a graph of
        `process` and `process_batch` captures."""
        depth, points, valid = self._body(inputs)
        return (depth, *partition_kept(points, valid))

    def _run(self, body, imgs: np.ndarray):
        """body on a [B, H, W, 3] batch, one graph replay once the batch
        shape is captured; on CUDA the host then waits for its outputs (the
        first pageable copy would block on the same work)."""
        inputs = {"img": torch.as_tensor(imgs, dtype=torch.float32)}
        outputs = self.graphs(body, inputs)
        if self.device.type == "cuda":
            with annotate("pseudolidar.wait"):
                torch.cuda.current_stream(self.device).synchronize()
        return outputs

    def infer(self, imgs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[B, H, W, 3] frames -> the program's (depth [B, H, W], points
        [B, H·W, 4], valid [B, H·W]) on the host, the clouds not compacted:
        one graph replay on the card once the batch shape is captured."""
        outputs = self._run(self._body, imgs)
        with annotate("pseudolidar.copy_out"):
            return tuple(t.cpu().numpy() for t in outputs)

    def process(self, img: np.ndarray, frame_index: int = 0) -> PipelineResult:
        """One [H, W, 3] frame -> depth + compacted cloud. The cloud is
        compacted on the pipeline's device; `pseudolidar.compact` holds
        the count's read and the rows' choice, `pseudolidar.copy_out` the
        copies of depth and the kept rows (module docstring)."""
        return self.process_batch(img[None], frame_index)[0]

    def process_batch(self, imgs: np.ndarray, frame_index: int = 0):
        """Multi-camera step: [S, H, W, 3] synchronized frames in one
        forward -> one PipelineResult per stream, each cloud compacted on
        the device and only its kept rows copied, as in `process`."""
        with annotate("pseudolidar.frame", frame_index):
            depth, points, count = self._run(self._compacting_body, imgs)
            with annotate("pseudolidar.compact"):
                counts = count.tolist()
                kept = [points[s, :n] for s, n in enumerate(counts)]
            with annotate("pseudolidar.copy_out"):
                depth = depth.cpu().numpy()
                clouds = [rows.cpu().numpy() for rows in kept]
            self.card_compactions += len(counts)
            self.kept_points += sum(counts)
            return [PipelineResult(frame_index, depth[s], cloud, stream_index=s)
                    for s, cloud in enumerate(clouds)]

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
