"""Device-time op breakdown from torch.profiler traces.

Counterpart of unsupervised_pseuso_lidar_tpu/utils/trace.py (_op_family
:43, summarize_xplane :51, op_breakdown :106): `op_breakdown(fn, *args)`
traces a few calls of `fn` with torch.profiler (utils/profiling.trace),
reads the ``*.pt.trace.json`` it wrote and returns milliseconds a call by
op family.

On a CUDA run the rows are the card's own events — kernels, copies and
fills (the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events), from every host thread that launched them (the autograd
engine's backward thread included) — so each microsecond of device time
is counted once: exclusive device time, as JAX's "XLA Ops" line. A CUDA
run whose trace holds no device event raises: without CUPTI the profiler
sees no device time, and the breakdown does not stand in host time for
it. On the CPU the rows are the self time of the host ops (``cpu_op``
events), as JAX falls back to the host plane.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import (
    hard_sync,
    tensor_leaves,
    trace,
    uses_cuda,
)

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORY = "cpu_op"
TRACE_GLOB = "*.pt.trace.json"

Rows = List[Tuple[str, float, int]]


def _mangled_prefix(name: str) -> str:
    """The qualified name of an Itanium-mangled symbol the trace left
    mangled (``_ZN7cutlass6KernelI...`` -> ``cutlass::Kernel``), up to its
    template or argument types."""
    rest = name[2:].removeprefix("N")
    parts = []
    while rest[:1].isdigit():
        digits = len(rest) - len(rest.lstrip("0123456789"))
        size = int(rest[:digits])
        parts.append(rest[digits:digits + size])
        rest = rest[digits + size:]
    return "::".join(parts) or name


def _op_family(name: str) -> str:
    """Trace event name -> op family: the leading ``void ``, anonymous
    namespaces, template arguments ``<...>``, the argument list ``(...)``
    and digits dropped, e.g. ``void at::native::vectorized_elementwise_kernel<4,
    ...>(int, ...)`` -> ``at::native::vectorized_elementwise_kernel``; a
    name left mangled keeps its qualified name. HLO names as JAX's
    (``%fusion.123 = ...`` -> ``fusion``) give the same family."""
    base = name.split(" = ")[0].strip().strip("%")
    if base.startswith("_Z"):
        base = _mangled_prefix(base)
    base = base.removeprefix("void ").replace("(anonymous namespace)::", "")
    kept, depth = [], 0
    for c in base:
        if c == "(" and depth == 0:
            break
        if c == "<":
            depth += 1
        elif c == ">" and depth:
            depth -= 1
        elif depth == 0:
            kept.append(c)
    base = "".join(kept).split(".")[0].strip()
    return "".join(c for c in base if not c.isdigit()) or base


def _trace_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _host_self_times(events: Sequence[dict]) -> List[Tuple[str, float]]:
    """(name, self µs) of each host op: its duration less its direct
    children's on the same thread."""
    threads: Dict[tuple, List[dict]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == HOST_CATEGORY:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        self_us = [float(e["dur"]) for e in evs]
        open_ops: List[Tuple[float, int]] = []  # (end, index), innermost last
        for i, e in enumerate(evs):
            while open_ops and open_ops[-1][0] <= e["ts"]:
                open_ops.pop()
            if open_ops:
                self_us[open_ops[-1][1]] -= float(e["dur"])
            open_ops.append((e["ts"] + e["dur"], i))
        out += [(e["name"], max(s, 0.0)) for e, s in zip(evs, self_us)]
    return out


def _device_busy_us(events: Sequence[dict]) -> float:
    """µs covered by at least one device event: the union of their
    [ts, ts + dur) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in events if e.get("cat") in DEVICE_CATEGORIES):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def _trace_rows(path: str, collapse: bool = True) -> Tuple[Rows, bool]:
    """(rows sorted by time, whether they are device events)."""
    events = _trace_events(path)
    timed = [(e["name"], float(e["dur"])) for e in events
             if e.get("cat") in DEVICE_CATEGORIES]
    on_device = bool(timed)
    if not on_device:
        timed = _host_self_times(events)
    total: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.Counter()
    for name, us in timed:
        key = _op_family(name) if collapse else name
        total[key] += us / 1e3
        counts[key] += 1
    rows = sorted(((k, v, counts[k]) for k, v in total.items()), key=lambda t: -t[1])
    return rows, on_device


def summarize_trace(path: str, collapse: bool = True) -> Rows:
    """[(op family, total ms, count)] of a ``*.pt.trace.json``: the device
    events when it holds any, else the host ops' self time.
    collapse=False keeps full kernel names (one row per kernel)."""
    return _trace_rows(path, collapse)[0]


def newest_trace(directory: str) -> str | None:
    """The most recent ``*.pt.trace.json`` under `directory`, or None."""
    dumps = glob.glob(os.path.join(directory, "**", TRACE_GLOB), recursive=True)
    return max(dumps, key=os.path.getmtime) if dumps else None


class Breakdown(dict):
    """{op family: ms a call} of a traced window, and its totals:
    `counts` (events a family over the window), `steps`, `total_ms` (device
    ms a call on a CUDA run, host self ms on the CPU), `host_ms` (host
    clock a call over the window, synchronized at its end), `busy_ms` (ms a
    call in which the device ran at least one event: the union of their
    intervals, less than total_ms where events overlap, as the kernels of
    a CUDA graph may; total_ms when not given), `busy` (busy_ms / host_ms:
    on a CUDA run the device's busy share; 1 - busy is its idle share) and
    `on_device`."""

    def __init__(self, rows: Rows, steps: int, host_ms: float, on_device: bool,
                 busy_ms: float | None = None):
        super().__init__((fam, ms / steps) for fam, ms, _ in rows)
        self.counts = {fam: count for fam, _, count in rows}
        self.steps = steps
        self.host_ms = host_ms
        self.on_device = on_device
        self.total_ms = sum(self.values())
        self.busy_ms = self.total_ms if busy_ms is None else busy_ms
        self.busy = self.busy_ms / host_ms if host_ms > 0 else float("nan")


def breakdown_from_trace(path: str, steps: int, host_ms: float,
                         on_cuda: bool) -> Breakdown:
    """The Breakdown of a trace of `steps` calls. A CUDA run (`on_cuda`)
    whose trace holds no device event raises."""
    rows, on_device = _trace_rows(path)
    if on_cuda and not on_device:
        raise RuntimeError(
            f"op_breakdown: the trace of a CUDA run ({path}) holds no device "
            "event (kernel, memcpy or memset): torch.profiler got no CUPTI "
            "activity from the card, so it cannot attribute device time"
        )
    busy_ms = _device_busy_us(_trace_events(path)) / 1e3 / steps if on_device else None
    return Breakdown(rows, steps, host_ms, on_device, busy_ms)


def print_breakdown(result: Breakdown, top: int = 20) -> None:
    what = "device time" if result.on_device else "CPU self time"
    print(f"[trace] {what} by op family ({result.total_ms:.2f} ms/step):")
    for fam, ms in list(result.items())[:top]:
        print(f"  {ms:9.3f} ms/step  x{result.counts[fam]:5d}  {fam}")
    share = "busy share" if result.on_device else "share"
    print(f"[trace] {what} {result.total_ms:.3f} ms/step in a "
          f"{result.host_ms:.3f} ms/step host window: {share} {result.busy:.3f}"
          + (f" ({result.busy_ms:.3f} ms/step busy)" if result.on_device else ""),
          flush=True)


def op_breakdown(
    fn: Callable,
    *args,
    steps: int = 5,
    warmup: int = 2,
    trace_dir: str | None = None,
    top: int = 20,
    verbose: bool = True,
) -> Breakdown:
    """Run `fn(*args)` `warmup` times, then `steps` times under a
    torch.profiler trace; return ms a call by op family (a Breakdown).

    The run is a CUDA run when a tensor of `args` or of fn's output lies
    on a card (with no tensor in either: when a card is available). The
    trace is kept in `trace_dir` when one is given.

    Example::

        op_breakdown(lambda: trainer.train_step(batch), steps=3)
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    leaves = tensor_leaves((args, out))
    on_cuda = any(t.is_cuda for t in leaves) if leaves else uses_cuda(None)

    def sync():  # fn may return nothing of what it launched
        if on_cuda:
            torch.cuda.synchronize()
        hard_sync(out)

    sync()
    with contextlib.ExitStack() as stack:
        directory = trace_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="torch_trace_"))
        with trace(directory, device="cuda" if on_cuda else "cpu"):
            t0 = time.perf_counter()
            for _ in range(steps):
                out = fn(*args)
            sync()
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
        path = newest_trace(directory)
        if path is None:
            raise RuntimeError(f"op_breakdown: torch.profiler wrote no trace to {directory}")
        result = breakdown_from_trace(path, steps, host_ms, on_cuda)
    if verbose:
        print_breakdown(result, top)
    return result
