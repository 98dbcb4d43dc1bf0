"""Profiling on torch.profiler, and the program's spans.

Counterpart of unsupervised_pseuso_lidar_tpu/utils/profiling.py
(hard_sync :29, trace :60, annotate :70): a completion barrier for timed
regions, a profiler trace around a region of training (a
``*.pt.trace.json`` that Perfetto and TensorBoard open), and named spans
in it.

A span, ``with annotate(name, unit):``, marks a region of the program at
a layer boundary (serving's wait, copies and compaction, a step graph's
copies and replay, the training step's host work). With no torch.profiler
session active it reads one flag and does nothing else: no
record_function, no clock, no allocation. Under a session it opens
``record_function(name)``, so that the span lands in the chrome trace on
the profiler's clock beside the card's events, and when it closes it
appends one Span to an in-memory table: its name, start and end
(``time.perf_counter_ns``), the time its child spans took, its id and its
parent's (the span open around it on the same thread), and the unit id
(a frame index, an optimizer step) its root span was given. The table
keeps the newest MAX_SPANS records and counts those it dropped;
``spans()``, ``span_totals(name)`` and ``clear_spans()`` read and empty
it. A span's self time is its duration less its children's.

A counter is a named number the program records for a reader outside it
(``set_counter(name, value)``, ``counter(name)``, the latest value
kept): ``train.saved_bytes``, the bytes a training step's eager call
saved for its backward (train/trainer.TrainStep), counted by SavedBytes.
SavedBytes, ``with SavedBytes(exclude=params) as saved:``, sums the
untyped storage of every tensor that autograd saves inside the block,
once per distinct storage, and leaves out the storages of `exclude` (the
weights); its hooks hand autograd each tensor as it is (detached, the
same storage), so the block computes the same bits.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as autograd_profiler
from torch.autograd.graph import saved_tensors_hooks
from torch.multiprocessing.reductions import StorageWeakRef

MAX_SPANS = 2 ** 16


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


class Span(NamedTuple):
    """One closed span of the table (module docstring); times in ns of
    time.perf_counter_ns."""

    name: str
    start_ns: int
    end_ns: int
    child_ns: int  # inside the span's child spans
    id: int
    parent: Optional[int]  # the enclosing span's id; None at a root
    unit: Optional[int]  # the root span's unit id

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns


class SpanTable:
    """The newest `size` Spans, oldest first, and how many were dropped to
    keep to that bound."""

    def __init__(self, size: int = MAX_SPANS):
        self.records: collections.deque = collections.deque(maxlen=size)
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(span)

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.dropped = 0


TABLE = SpanTable()
_ids = itertools.count()
_open = threading.local()  # .stack: this thread's open spans, innermost last


class _Off:
    """What annotate returns with no profiler session: a ``with`` that does
    nothing, one object for every span."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, kind, value, traceback) -> None:
        return None


_OFF = _Off()


class _Open:
    """A span under a profiler session (module docstring)."""

    __slots__ = ("name", "id", "parent", "unit", "start_ns", "child_ns", "record")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self) -> None:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.id, self.parent = next(_ids), outer.id if outer else None
        if self.unit is None and outer is not None:
            self.unit = outer.unit
        self.child_ns = 0
        stack.append(self)
        # the clock outside record_function: the trace's event lies within
        # the table's span, which holds the instrument's own cost
        self.start_ns = time.perf_counter_ns()
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()

    def __exit__(self, *exc) -> None:
        self.record.__exit__(*exc)
        end = time.perf_counter_ns()
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += end - self.start_ns
        TABLE.add(Span(self.name, self.start_ns, end, self.child_ns, self.id, self.parent,
                       self.unit))


def annotate(name: str, unit: Optional[int] = None):
    """A span named `name` (module docstring) around a ``with`` block; `unit`
    is the unit id of a root span (its children take their root's). Off,
    with no torch.profiler session active, it is one flag read."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, unit)


def spans() -> List[Span]:
    """The table's Spans, in the order they closed (children before their
    parents)."""
    return list(TABLE.records)


def span_totals(name: str) -> Tuple[int, int]:
    """(count, total self ns) of the table's spans named `name`."""
    count = total = 0
    for span in TABLE.records:
        if span.name == name:
            count += 1
            total += span.self_ns
    return count, total


def clear_spans() -> None:
    """Empty the table and its count of dropped spans."""
    TABLE.clear()


COUNTERS: Dict[str, int] = {}


def set_counter(name: str, value: int) -> None:
    """Record `value` as the counter `name` (module docstring)."""
    COUNTERS[name] = int(value)


def counter(name: str) -> Optional[int]:
    """The counter `name`'s latest value; None where none was recorded."""
    return COUNTERS.get(name)


class SavedBytes:
    """The bytes autograd saves for the backward inside a ``with`` block
    (module docstring): `bytes` once the block has closed."""

    def __init__(self, exclude: Iterable[torch.Tensor] = ()):
        self._excluded = {t.untyped_storage()._cdata for t in exclude}
        # a weak reference pins each counted storage's address (not its
        # memory), so a storage freed in the block and another allocated
        # at its address count as two
        self._seen: Dict[int, StorageWeakRef] = {}
        self._hooks = saved_tensors_hooks(self._pack, _unpack)
        self.bytes = 0

    def _pack(self, tensor: torch.Tensor) -> torch.Tensor:
        storage = tensor.untyped_storage()
        key = storage._cdata
        if key not in self._excluded and key not in self._seen:
            self._seen[key] = StorageWeakRef(storage)
            self.bytes += storage.nbytes()
        # the tensor itself would tie an output to its own grad_fn in a
        # reference cycle; its detached alias holds the same storage
        return tensor.detach()

    def __enter__(self) -> "SavedBytes":
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._hooks.__exit__(*exc)
        self._seen.clear()


def _unpack(tensor: torch.Tensor) -> torch.Tensor:
    return tensor
