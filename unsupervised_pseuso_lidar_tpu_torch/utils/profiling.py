"""Profiling and step timing on torch.profiler.

Counterpart of unsupervised_pseuso_lidar_tpu/utils/profiling.py
(hard_sync :29, trace :60, annotate :70, StepTimer :77-124): a completion
barrier for timed regions, a profiler trace around a region of training
(a ``*.pt.trace.json`` that Perfetto and TensorBoard open), named
sub-regions in it, and a step timer whose summary is a metric.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

import torch


def tensor_leaves(tree) -> List[torch.Tensor]:
    """Every tensor in a nested dict / list / tuple."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tensor_leaves(item)]
    return []


def hard_sync(tree) -> float:
    """Wait until the device has finished everything the tensors of `tree`
    depend on: ``torch.cuda.synchronize`` on each CUDA device among them,
    then one data-dependent scalar read back to the host (the sum of each
    non-empty tensor's first element, as JAX's probe reads). Returns that
    value (unused; 0.0 for a tree without tensors)."""
    leaves = [t.detach() for t in tensor_leaves(tree)]
    for device in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(device)
    return float(sum(float(t.reshape(-1)[0].float()) for t in leaves
                     if t.numel() and not t.is_complex()))


def uses_cuda(device=None) -> bool:
    """Whether a region on `device` runs on a CUDA card (None: whether one
    is available)."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[None]:
    """Capture a torch.profiler trace of the region into `log_dir` (a
    ``<host>_<pid>.<ns>.pt.trace.json`` that Perfetto and TensorBoard
    open): host ops always, the card's kernels, copies and fills when the
    region runs on `device` = CUDA (None: when a card is available)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if uses_cuda(device):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside an active trace."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-clock step timing with percentile summaries.

    Blocks on the step outputs (hard_sync) before stopping the clock only
    when `blocking=True`; otherwise it measures the dispatch cadence.
    """

    def __init__(self, blocking: bool = True):
        self.blocking = blocking
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        if self.blocking and outputs is not None:
            hard_sync(outputs)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.samples.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self, outputs_fn=None):
        """Time one step; `outputs_fn` (called AFTER the body) returns the
        step outputs so blocking mode can sync on them:

            with timer.step(lambda: out):
                out = step(batch)
        """
        self.start()
        yield
        self.stop(outputs_fn() if outputs_fn is not None else None)

    def summary(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        if not self.samples:
            return {}
        xs = sorted(self.samples)
        n = len(xs)
        out = {
            "steps": float(n),
            "mean_s": sum(xs) / n,
            "p50_s": xs[n // 2],
            "p95_s": xs[min(n - 1, int(n * 0.95))],
            "max_s": xs[-1],
        }
        if batch_size:
            out["frames_per_sec"] = batch_size / out["mean_s"]
        return out
