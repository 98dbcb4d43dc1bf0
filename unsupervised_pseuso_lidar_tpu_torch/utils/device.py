"""Device selection for the port's entry points, and timing on the card.

Entry points default to the CUDA card. Without one they raise instead of
running on the CPU: a CPU run is explicit (``device="cpu"``), never a
silent fallback. ``device_time_ms`` and ``card`` are what chip_smoke.py
and ops/cuda/tune.py measure and label their numbers with. ``constant``
holds the small tensors a step reads on the device, made once.
"""

from __future__ import annotations

import functools
import statistics
import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and no CUDA
    device is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.tensor(values, dtype, device), made on the first call for
    (values, dtype, device) and the same tensor on every later one: a step
    that reads it copies nothing from the host, which a CUDA graph could
    not capture. `values` is a (nested) tuple of numbers. Callers read it
    and never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def device_time_ms(fn, calls: int = 20, runs: int = 5, warmup: int = 3) -> float:
    """Device time of one call of fn on the current CUDA stream, in ms:
    one CUDA-event pair around `calls` back-to-back calls, divided by
    `calls`; the median of `runs` such runs. The host's work before each
    launch overlaps the card's work on the previous call, so it is not
    counted unless it is the longer of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def card() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
