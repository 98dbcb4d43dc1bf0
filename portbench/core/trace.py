"""A traced slice of a run, read from torch.profiler's trace.

`profile(call, units, directory)` runs `call` `units` times under
torch.profiler (host ops and the card's kernels, copies and fills through
CUPTI), writes the chrome trace under `directory` and reads it back into a
TraceSlice: the device events inside the slice, the device's busy time
(the union of their intervals), the slice's length, ms by op family, and
the idle gaps named by what the host was doing.

`op_family`, `_mangled_prefix` and `device_busy_us` are copies of the
program's utils/trace.py (`_op_family`, `_mangled_prefix`,
`_device_busy_us`), kept here so that a change to the program cannot move
the yardstick.
"""

from __future__ import annotations

import collections
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
                   "cuda_driver")
WINDOW = "portbench.window"
UNIT = "portbench.unit"


def _mangled_prefix(name: str) -> str:
    rest = name[2:].removeprefix("N")
    parts = []
    while rest[:1].isdigit():
        digits = len(rest) - len(rest.lstrip("0123456789"))
        size = int(rest[:digits])
        parts.append(rest[digits:digits + size])
        rest = rest[digits + size:]
    return "::".join(parts) or name


def op_family(name: str) -> str:
    """Trace event name -> op family: the leading ``void ``, anonymous
    namespaces, template arguments, the argument list and digits dropped;
    a mangled name keeps its qualified name."""
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


def device_busy_us(events: Sequence[dict]) -> float:
    """µs covered by at least one device event: the union of their
    [ts, ts + dur) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in events if e.get("cat") in DEVICE_CATEGORIES):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def _merged(events: Sequence[dict]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in events):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


@dataclass
class TraceSlice:
    """What the traced slice of a run read. Times in µs of the trace's
    clock; `units` is the steps or frames the slice ran."""

    units: int
    window_us: float
    busy_us: float
    device_events: List[dict]
    family_us: Dict[str, float]
    family_counts: Dict[str, int]
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    extra: Dict = field(default_factory=dict)

    def kernel_us(self, family: str) -> float:
        return self.family_us.get(family, 0.0)

    def breakdown(self, top: int = 10) -> Dict:
        ops = sorted(self.family_us.items(), key=lambda kv: -kv[1])[:top]
        by_host: Dict[str, float] = collections.defaultdict(float)
        for name, us in self.gaps:
            by_host[name] += us
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, us / 1e6] for name, us in ops],
                "idle_gaps": [[name, us / 1e6] for name, us in gaps]}


def read_trace(path: str, units: int) -> TraceSlice:
    """The TraceSlice of a chrome trace holding one WINDOW annotation."""
    with open(path) as f:
        data = json.load(f)
    events = [e for e in (data["traceEvents"] if isinstance(data, dict) else data)
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") in ("user_annotation", "cpu_op")]
    if not windows:
        raise RuntimeError(f"the trace {path} holds no {WINDOW} annotation")
    window = max(windows, key=lambda e: float(e["dur"]))
    lo, hi = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, stop = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if stop > start:
            device.append({**e, "ts": start, "dur": stop - start})
    if not device:
        raise RuntimeError(
            f"the trace {path} holds no device event in its window: torch.profiler got "
            "no CUPTI activity from the card")
    family_us: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.Counter()
    for e in device:
        fam = op_family(e["name"])
        family_us[fam] += float(e["dur"])
        counts[fam] += 1
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES
            and e.get("tid") == window.get("tid") and e is not window]
    gaps = []
    cursor = lo
    for start, stop in _merged(device) + [(hi, hi)]:
        if start > cursor:
            mid = 0.5 * (cursor + start)
            inside = [e for e in host
                      if float(e["ts"]) <= mid < float(e["ts"]) + float(e["dur"])]
            name = (min(inside, key=lambda e: float(e["dur"]))["name"] if inside
                    else "host outside any op")
            gaps.append((name, start - cursor))
        cursor = max(cursor, stop)
    return TraceSlice(units, hi - lo, device_busy_us(device), device, dict(family_us),
                      dict(counts), gaps)


def profile(call: Callable[[int], None], units: int, directory: str,
            device: torch.device) -> TraceSlice:
    """call(i) for i in range(units) under torch.profiler, the card
    synchronized before and after -> the slice's TraceSlice. The trace is
    written under `directory` and deleted once read."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    with torch_profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for i in range(units):
                with record_function(UNIT):
                    call(i)
            sync()
            host_s = time.perf_counter() - t0
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"portbench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        result = read_trace(path, units)
    finally:
        os.remove(path)
    result.extra["host_window_s"] = host_s
    return result
