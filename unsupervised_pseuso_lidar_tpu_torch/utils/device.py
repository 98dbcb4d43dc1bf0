"""Device selection for the port's entry points.

Entry points default to the CUDA card. Without one they raise instead of
running on the CPU: a CPU run is explicit (``device="cpu"``), never a
silent fallback.
"""

from __future__ import annotations

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
