"""The card: the look for it, what a result says of it, and the import
check.

A measuring run needs CUDA and as many cards as its cell asks for; without
them it raises NoCard and prints no result, and never falls back to the
CPU. The CPU is only for the tests, which call the drivers directly.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List

import torch

# top-level module names that must not be loaded: JAX and the JAX package
# (compared whole: the port's package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "unsupervised_pseuso_lidar_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark measures the card")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} cards, torch sees {torch.cuda.device_count()}")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """nvidia-smi's name and power limit line, or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def describe(device: torch.device, count: int, peak_bytes: int) -> Dict:
    """The result's `device` record."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def set_cache_dirs(root: str) -> None:
    """Keep the kernel caches a CUDA process may write inside the checkout,
    at fixed paths (the port's nvcc libraries go to build/torch_ext/)."""
    cache = os.path.join(root, "build", "portbench_cache")
    for key, sub in (("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[key] = os.path.join(cache, sub)


def apply_flags(flags: Dict) -> None:
    """The backend flags a configuration states."""
    torch.backends.cudnn.allow_tf32 = bool(flags["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(flags["matmul_allow_tf32"])
    torch.backends.cudnn.benchmark = bool(flags["cudnn_benchmark"])
    torch.backends.cudnn.deterministic = bool(flags["cudnn_deterministic"])


def reference_flags() -> None:
    """Full float32 for the plain reference: no TF32 anywhere."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_reserved(device: torch.device) -> int:
    return torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0


def pool_bytes(device: torch.device, pool) -> int:
    """Bytes in the segments of the CUDA graph memory pool `pool` (a
    graph_pool_handle), from the caching allocator's snapshot; 0 off the
    card or without a pool."""
    if device.type != "cuda" or pool is None:
        return 0
    segments = torch.cuda.memory_snapshot()
    return sum(s["total_size"] for s in segments
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
