"""The step as one program on the card: CUDA graphs of a step's body.

Counterpart of the JAX package's jitted steps (train/trainer.py
_jit_with_mesh :404-416, make_train_step :419, make_multi_step :447,
make_eval_step :480). XLA compiles a step into one program that the
device runs whole; on the card the counterpart is a CUDA graph, the
step's kernels captured once and replayed with one launch. TrainStep,
make_multi_step and EvalStep (train/trainer.py) run their bodies through
a StepGraphs, and so does serving, the counterpart of JAX's jitted
serving function (pseudolidar/pipeline.py :99): DepthToPointCloudPipeline's
depth -> cloud program, the pose-only eval step (eval/pose.py :154) and
cli.odometry's pose forward (cli/odometry.py :69). Each caller hands its
StepGraphs the `graph` and the mesh it was given, and StepGraphs alone
decides whether the body is captured (graph_enabled): on a CUDA device
without a mesh or under an NCCL mesh by default. Where nothing is
captured (the CPU, a gloo mesh, graph=False) every call runs the body
eagerly, as it is. A serving body runs under torch.no_grad and returns
a tuple of tensors; each pipeline and each pose step has its graphs and
its pool of its own.

A body is a function of a flat dict of tensors: the batch's arrays and the
step's host values as tensors (the automask warm-up scale, the learning
rates, the augmentation draws). It reads every one of them on the device,
copies nothing from the host and waits for nothing, so all of its launches
can be captured. Under an NCCL mesh its collectives are captured too:
NCCL runs them as kernels on its own stream, which waits for the stream
that calls it and is waited for in turn, so inside a capture they join
the graph in the order the body calls them (the all-reduces of autograd's
backward as well, which runs on the forward's stream). The first, eager
call creates NCCL's communicators, which a capture cannot. A gloo mesh
runs its collectives on the host and is never captured. StepGraphs keys
a body by the signature of its inputs (keys, shapes, dtypes), by the
caller's `static` values (host values that shape the program, passed to
the body after its inputs, as jit's static arguments: the global image
height under a spatial axis) and by
the backend flags that choose its kernels (cuDNN's and cuBLAS's TF32,
cuDNN's deterministic and benchmark modes: a graph keeps the kernels it
captured), as jit keys a program:

- the first call of a signature runs the body eagerly, on a side stream,
  and is the real step: cuDNN's algorithm search and the first step's
  transient memory happen here, outside the graph's pool;
- the second copies its inputs into static buffers, captures the body
  into a graph and replays it;
- every later call copies its inputs into those buffers (host to device,
  or device to device for a batch prefetched to the card) and replays.

The outputs are cloned after each replay, so what one call returned is not
overwritten by the next. A graph's kernel launches are counted on each
replay (ops/cuda/kernels.captured_launches, add_launches). There is no
fallback: a capture or a replay that fails raises.

A graph reads the modules' parameters and buffers where they lay when it
was captured: weights copied into them in place (load_state_dict,
train/checkpoint.load_serving_weights) are what the next replay reads.
StepGraphs given the `modules` a body reads raises, on the next call,
where one of their parameters, buffers or submodules was replaced or
moved instead (reset() drops the graphs and takes them as they are).

With capture=False (the CPU) the same protocol runs the body on the
static buffers instead of capturing it: what the CPU tests hold against
the eager step, bit for bit.

`on_eager` is entered around a signature's first call whether or not
the body is captured: the train step counts the bytes saved for its
backward there, once a signature.

Under a torch.profiler session a call of a graphed body records its spans
(utils/profiling.annotate): `graph.check_weights` (the modules' storage
checked once a graph exists), `graph.eager` and `graph.capture` (a
signature's first and second calls), `graph.copy_in` (the inputs copied
into the static buffers, at the capture and before every replay),
`graph.replay` and `graph.clone_out`. Nothing inside a captured body has
a span: a capture records none, and a replay runs no host code.
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, ContextManager, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import annotate

Body = Callable[..., Any]  # body(inputs: Dict[str, torch.Tensor], *static)


def graph_enabled(graph: Optional[bool], device: torch.device, mesh=None) -> bool:
    """A step's `graph` argument -> whether it runs as CUDA graphs. None:
    where capture applies, a CUDA device without a mesh (or under a mesh
    without a process group, which runs no collective) or under an NCCL
    mesh (Mesh.capturable). False: eagerly. True: captured, and a
    ValueError saying why where capture does not apply — on the CPU, and
    under a gloo mesh, whose collectives run on the host."""
    if mesh is not None and not mesh.distributed:
        mesh = None
    if graph is None:
        return device.type == "cuda" and (mesh is None or mesh.capturable)
    if graph and device.type != "cuda":
        raise ValueError(
            f"graph=True needs a CUDA device: a CUDA graph captures the card's "
            f"kernels, and this step runs on {device}")
    if graph and not (mesh is None or mesh.capturable):
        raise ValueError(
            f"graph=True under a {dist.get_backend(mesh.group)} mesh: its collectives "
            f"run on the host (gloo's do), where a CUDA graph cannot hold them; an "
            f"NCCL mesh can be captured. Pass graph=None or False")
    return bool(graph)


@functools.lru_cache(maxsize=None)
def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream of `device` on which every step's first, eager call
    runs and every graph is captured. One for all: cuBLAS keeps a
    workspace for each stream it has run on for the life of the process,
    and a stream a step would leave one behind each, pinning the cached
    memory segment it was carved from."""
    return torch.cuda.Stream(device)


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out


def _storage_of(modules: Sequence[nn.Module]) -> list:
    """(registry, name, value, address) of every parameter, buffer and
    submodule of `modules`: what their graphs read, and where."""
    out = []
    for module in modules:
        for m in module.modules():
            for registry in (m._parameters, m._buffers):
                out += [(registry, k, t, None if t is None else t.data_ptr())
                        for k, t in registry.items()]
            out += [(m._modules, k, sub, None) for k, sub in m._modules.items()]
    return out


def _moved(storage: list) -> bool:
    """Whether a value of a _storage_of list was replaced or lies elsewhere."""
    for registry, name, value, address in storage:
        now = registry.get(name)
        if now is not value or (address is not None and now.data_ptr() != address):
            return True
    return False


def _signature(body: Body, inputs: Dict[str, Any], static: tuple) -> tuple:
    """What a body's graph is keyed by: the body, the caller's static
    values, the backend flags that choose its kernels and its inputs'
    keys, shapes and dtypes (module docstring)."""
    backends = torch.backends
    return (getattr(body, "__qualname__", None), static, backends.cudnn.allow_tf32,
            backends.cuda.matmul.allow_tf32, backends.cudnn.deterministic,
            backends.cudnn.benchmark,
            *sorted((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))


def _copy_in(static: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor]) -> None:
    """Copy a call's inputs into a graph's static buffers."""
    with annotate("graph.copy_in"):
        for k, v in inputs.items():
            static[k].copy_(v, non_blocking=True)


@dataclass
class Captured:
    """One signature's graph: its static input buffers, the outputs its
    replay writes, the kernel launches of one replay and the seconds the
    capture took. graph is None with capture=False."""

    graph: Optional[torch.cuda.CUDAGraph]
    static: Dict[str, torch.Tensor]
    outputs: Any
    launches: Dict[str, int]
    seconds: float


class StepGraphs:
    """body(inputs) as CUDA graphs, one per signature of `inputs` (module
    docstring), where the step's `graph` and `mesh` say that capture
    applies (graph_enabled, which raises for graph=True where it does
    not); eagerly at every call otherwise. capture=False runs the graph
    protocol on static buffers without capturing (the CPU tests' seam).
    `pool` is the graphs' private memory pool
    (torch.cuda.graph_pool_handle()): steps that never run at the same
    time share one (a Trainer's train and eval steps); None makes one
    where the body is captured, and leaves it None elsewhere. `modules`:
    the modules whose parameters and buffers the body reads, checked
    before every call once a graph exists (module docstring)."""

    def __init__(self, device: torch.device, graph: Optional[bool] = None, mesh=None,
                 pool=None, capture: bool = True, modules: Sequence[nn.Module] = ()):
        self.device = torch.device(device)
        self.capture = capture
        self._graphed = graph_enabled(graph, self.device, mesh) or not capture
        if pool is None and self._graphed and capture:
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self.modules = tuple(modules)
        self.graphs: Dict[tuple, Captured] = {}
        self.replays = 0  # graph launches so far
        self._warm: set = set()
        self._storage: Optional[list] = None

    @property
    def graphed(self) -> bool:
        """Whether the body runs as graphs (captured and replayed, or on
        static buffers with capture=False) rather than eagerly at every
        call."""
        return self._graphed

    def reset(self) -> None:
        """Drop every graph: the next call of each signature runs eagerly
        again, the one after captures anew."""
        self.graphs.clear()
        self._warm.clear()
        self._storage = None

    def __call__(self, body: Body, inputs: Dict[str, Any], static: tuple = (),
                 on_eager: Optional[Callable[[], ContextManager]] = None) -> Any:
        """body(inputs, *static), eager, captured or replayed (module
        docstring). `static`: hashable host values that body takes after
        `inputs`, as jit's static arguments; each tuple of values has
        graphs of its own. `on_eager`: a context manager's factory, entered
        around a signature's first, eager call alone (the train step counts
        the bytes saved for its backward there), captured or not."""
        if not self._graphed:
            return self._uncaptured(body, inputs, static, on_eager)
        if self.graphs:
            with annotate("graph.check_weights"):
                moved = _moved(self._storage)
            if moved:
                raise RuntimeError(
                    "a parameter, buffer or submodule that these CUDA graphs read was "
                    "replaced or moved after the capture; copy new weights into the "
                    "tensors in place (load_state_dict, load_serving_weights) or call "
                    "reset() first")
        inputs = {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                  for k, v in inputs.items()}
        key = _signature(body, inputs, static)
        if key not in self._warm:
            with annotate("graph.eager"), (on_eager or contextlib.nullcontext)():
                outputs = self._eager(body, inputs, static)
            self._warm.add(key)
            return outputs
        captured = self.graphs.get(key)
        if captured is None:
            if not self.graphs:
                self._storage = _storage_of(self.modules)
            with annotate("graph.capture"):
                captured = self.graphs[key] = self._capture(body, inputs, static)
        else:
            _copy_in(captured.static, inputs)
        if captured.graph is None:
            return body(captured.static, *static)
        with annotate("graph.replay"):
            captured.graph.replay()
        self.replays += 1
        kernels.add_launches(captured.launches)
        with annotate("graph.clone_out"):
            return _map(torch.clone, captured.outputs)

    def _uncaptured(self, body: Body, inputs: Dict[str, Any], static: tuple,
                    on_eager: Optional[Callable[[], ContextManager]]) -> Any:
        """body(inputs, *static) as it is, with no buffer, copy or span of
        its own; on_eager entered around a signature's first call."""
        if on_eager is not None:
            key = _signature(body, inputs, static)
            if key not in self._warm:
                self._warm.add(key)
                with on_eager():
                    return body(inputs, *static)
        return body(inputs, *static)

    def _eager(self, body: Body, inputs: Dict[str, torch.Tensor], args: tuple) -> Any:
        if not self.capture:
            return body(inputs, *args)
        side = side_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outputs = body(inputs, *args)
        current.wait_stream(side)
        for t in inputs.values():
            if t.is_cuda:  # the caller may free it once the call returns
                t.record_stream(side)
        for t in _leaves(outputs):
            t.record_stream(current)
        return outputs

    def _capture(self, body: Body, inputs: Dict[str, torch.Tensor], args: tuple) -> Captured:
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                  for k, v in inputs.items()}
        _copy_in(static, inputs)
        if not self.capture:
            return Captured(None, static, None, {}, 0.0)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # thread_local: a loader thread's pinned allocations may go on
        # while this thread captures
        with kernels.captured_launches() as launches:
            with torch.cuda.graph(graph, pool=self.pool, stream=side_stream(self.device),
                                  capture_error_mode="thread_local"):
                outputs = body(static, *args)
        return Captured(graph, static, outputs, launches, time.perf_counter() - t0)
