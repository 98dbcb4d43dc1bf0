"""The port's profiler layer on the CPU: utils/profiling.py (hard_sync,
trace, the spans of annotate and their table) and utils/trace.py
(op_breakdown, summarize_trace, _op_family), held to the JAX package's
utils where they compute the same thing (_op_family on HLO names).

The CUDA half (device events of the card's kernels) runs on the card:
tests/test_torch_cuda.py and chip_smoke.py's profile phase. Here a trace
without device events stands in for a CUDA run whose profiler saw none.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from unsupervised_pseuso_lidar_tpu.utils.trace import _op_family as jax_op_family
from unsupervised_pseuso_lidar_tpu_torch.utils import profiling
from unsupervised_pseuso_lidar_tpu_torch.utils import trace as trace_module
from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import (
    SpanTable,
    annotate,
    clear_spans,
    hard_sync,
    span_totals,
    spans,
    trace,
)
from unsupervised_pseuso_lidar_tpu_torch.utils.trace import (
    Breakdown,
    _op_family,
    breakdown_from_trace,
    newest_trace,
    op_breakdown,
    summarize_trace,
)

torch.set_num_threads(1)


def test_hard_sync_reads_every_leaf_of_a_nested_tree():
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 2), (4,), (2, 2, 2)))
    tree = {"a": a, "rest": [b, (c, "not a tensor", torch.zeros(0))],
            "flag": torch.tensor(True)}
    got = hard_sync(tree)
    assert isinstance(got, float)
    assert got == pytest.approx(float(a[0, 0]) + float(b[0]) + float(c[0, 0, 0]) + 1.0)
    assert hard_sync({"x": [1, 2], "y": None}) == 0.0
    assert hard_sync(torch.arange(5, 0, -1)) == 5.0


# real kernel names as torch.profiler's CUDA trace shows them (the four of
# the port's kernels and library ones from a basic_config step on the H100)
KERNEL_FAMILIES = [
    ("warp_bilinear_fwd_kernel(float const*, float const*, float*, int, int, int, int, int)",
     "warp_bilinear_fwd_kernel"),
    ("warp_bilinear_bwd_grid_kernel(float const*, float const*, float const*, float*, int, "
     "int, int, int, int)", "warp_bilinear_bwd_grid_kernel"),
    ("void (anonymous namespace)::ssim_fwd_kernel<true>(float const*, float const*, float*, "
     "int, int, int, float)", "ssim_fwd_kernel"),
    ("void (anonymous namespace)::ssim_bwd_kernel<true, false, true>(float const*, float "
     "const*, float const*, float*, float*, int, int, int, float)", "ssim_bwd_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, 4, 4> >"
     "(at::native::ReduceOp<float, at::native::MeanOps<float, float, float, float>, "
     "unsigned int, float, 4, 4>)", "at::native::reduce_kernel"),
    ("void cudnn::bn_bw_C_kernel_new<float, float, float2, 512, true, 1, true>(float const*, "
     "float const*)", "cudnn::bn_bw_C_kernel_new"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x64x32_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cudnn",
     "sm_xmma_fprop_implicit_gemm_ff_tff_f_nhwckrsc_nhwc_tilesizexx_warpgroupsizexx_"
     "execute_segment_k_off_kernel__x_cudnn"),
    ("_ZN17cutlass_80_cudnn_6KernelINS_4conv6kernel23ImplicitGemmConvolutionEEEvNT_6ParamsE",
     "cutlass__cudnn_::Kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD"),
    ("Memset (Device)", "Memset"),
    ("aten::convolution_backward", "aten::convolution_backward"),
]


@pytest.mark.parametrize("name,family", KERNEL_FAMILIES)
def test_op_family_of_kernel_names(name, family):
    assert _op_family(name) == family


@pytest.mark.parametrize("name", ["%fusion.123 = bf16[2,2] fusion(...)", "copy-start.4",
                                  "%convolution.7", "reduce-window.12"])
def test_op_family_of_hlo_names_equals_jax(name):
    # JAX's own cases (tests/test_utils.py) and two more HLO names
    assert _op_family(name) == jax_op_family(name)


def _conv_matmul():
    conv = torch.nn.Conv2d(3, 8, 3)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 24, 24, generator=gen)
    w = torch.randn(48, 48, generator=gen)

    def fn(x):
        with annotate("conv_then_matmul"):
            return conv(x).relu().sum() + (w @ w).sum()

    return fn, x


def test_op_breakdown_on_the_cpu_returns_aten_families(tmp_path, capsys):
    fn, x = _conv_matmul()
    result = op_breakdown(fn, x, steps=2, warmup=1, trace_dir=str(tmp_path))
    assert isinstance(result, Breakdown) and not result.on_device
    assert result.steps == 2 and result.host_ms > 0
    aten = {k: v for k, v in result.items() if k.startswith("aten::")}
    assert aten and all(v >= 0 for v in result.values())
    assert result["aten::mm"] > 0 and result["aten::convolution"] >= 0
    assert any("conv" in k and v > 0 for k, v in aten.items())
    # counts are over the window: one matmul a call
    assert result.counts["aten::mm"] == 2
    assert result.total_ms == pytest.approx(sum(result.values()))
    assert 0 < result.busy <= 1.0 + 1e-9
    # the user annotation's own time is not an op's
    assert "conv_then_matmul" not in result
    out = capsys.readouterr().out
    assert "[trace] CPU self time by op family" in out
    assert "host window" in out and "device" not in out


def test_trace_writes_a_trace_that_summarize_reads_back(tmp_path):
    fn, x = _conv_matmul()
    fn(x)
    with trace(str(tmp_path / "region"), device="cpu"):
        for _ in range(3):
            fn(x)
    path = newest_trace(str(tmp_path / "region"))
    assert path is not None and path.endswith(".pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "conv_then_matmul" for e in events)
    rows = summarize_trace(path)
    families = {fam: (ms, n) for fam, ms, n in rows}
    assert families["aten::mm"][1] == 3 and families["aten::mm"][0] > 0
    assert [ms for _, ms, _ in rows] == sorted((ms for _, ms, _ in rows), reverse=True)
    # collapse=False keeps each full name
    full = {name for name, _, _ in summarize_trace(path, collapse=False)}
    assert "aten::mm" in full and "aten::conv2d" in full and "aten::convd" not in full

    # op_breakdown's kept trace reads back with its own families and times
    result = op_breakdown(fn, x, steps=2, warmup=1, trace_dir=str(tmp_path / "ob"),
                          verbose=False)
    again = summarize_trace(newest_trace(str(tmp_path / "ob")))
    assert sorted(result) == sorted(fam for fam, _, _ in again)
    for fam, ms, n in again:
        assert result[fam] == pytest.approx(ms / 2) and result.counts[fam] == n


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_a_cuda_run_without_device_events_raises(tmp_path):
    # a trace whose profiler saw only the host, as one without CUPTI would
    # write it: on a CUDA run it must raise, not report host time
    host_only = _write_trace(tmp_path / "host.pt.trace.json", [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
         "tid": 1, "ts": 10.0, "dur": 5.0},
    ])
    with pytest.raises(RuntimeError, match="no device event"):
        breakdown_from_trace(host_only, steps=1, host_ms=1.0, on_cuda=True)
    cpu = breakdown_from_trace(host_only, steps=1, host_ms=1.0, on_cuda=False)
    assert dict(cpu) == {"aten::add": 0.05} and not cpu.on_device


def test_device_events_are_summed_once_from_every_thread(tmp_path):
    # kernels, copies and fills count, each once, from both host threads
    # (the autograd engine launches the backward from its own); host ops,
    # runtime calls and GPU-side annotations do not
    path = _write_trace(tmp_path / "cuda.pt.trace.json", [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1, "tid": 1,
         "ts": 0, "dur": 900},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
         "tid": 1, "ts": 1, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "warp_bilinear_fwd_kernel(float const*)",
         "pid": 0, "tid": 7, "ts": 10, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "warp_bilinear_bwd_grid_kernel(float const*)",
         "pid": 0, "tid": 7, "ts": 120, "dur": 200, "args": {"thread": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "pid": 0, "tid": 7, "ts": 330, "dur": 30},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
         "ts": 370, "dur": 20},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 7,
         "ts": 10, "dur": 380},
        {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7, "ts": 5},
    ])
    got = breakdown_from_trace(path, steps=2, host_ms=1.0, on_cuda=True)
    assert got.on_device
    assert dict(got) == pytest.approx({"warp_bilinear_bwd_grid_kernel": 0.1,
                                       "warp_bilinear_fwd_kernel": 0.05,
                                       "Memcpy HtoD": 0.015, "Memset": 0.01})
    assert got.total_ms == pytest.approx(0.175) and got.busy == pytest.approx(0.175)
    assert got.busy_ms == pytest.approx(0.175)
    assert got.counts["warp_bilinear_fwd_kernel"] == 1


def test_busy_share_counts_overlapping_device_events_once(tmp_path):
    # a CUDA graph may run kernels side by side: total_ms sums the events,
    # busy_ms takes the union of their intervals (0-100, 50-150, 300-350:
    # 200 us busy of 250 us summed), and the busy share is busy_ms's
    path = _write_trace(tmp_path / "graph.pt.trace.json", [
        {"ph": "X", "cat": "kernel", "name": "a_kernel", "pid": 0, "tid": 7,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "b_kernel", "pid": 0, "tid": 8,
         "ts": 50, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "c_kernel", "pid": 0, "tid": 7,
         "ts": 60, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
         "pid": 0, "tid": 7, "ts": 300, "dur": 50},
    ])
    got = breakdown_from_trace(path, steps=1, host_ms=0.5, on_cuda=True)
    assert got.total_ms == pytest.approx(0.27)
    assert got.busy_ms == pytest.approx(0.2) and got.busy == pytest.approx(0.4)


def test_host_self_time_subtracts_children():
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 1, "tid": 1,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1, "tid": 1,
         "ts": 10, "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 1, "tid": 1,
         "ts": 20, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 2,
         "ts": 5, "dur": 40},
    ]
    got = dict(trace_module._host_self_times(events))
    assert got == {"aten::linear": 40.0, "aten::addmm": 50.0, "aten::copy_": 10.0,
                   "aten::add": 40.0}


# the program's spans (utils/profiling.annotate and its table)

class _Refused:
    """Stands in for record_function and the clock: any use raises."""

    def __call__(self, *args, **kwargs):
        raise AssertionError("a span with no profiler active used record_function or the clock")

    perf_counter_ns = __call__


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, traceback):
        return None


@pytest.mark.parametrize("unit", [None, 0, 7])
def test_a_span_without_a_profiler_is_one_flag_read(monkeypatch, unit):
    # no record_function, no clock, no record, the same object every time,
    # and an exception in the block goes through
    clear_spans()
    monkeypatch.setattr(torch.profiler, "record_function", _Refused())
    monkeypatch.setattr(profiling, "time", _Refused())
    assert annotate("a", unit) is annotate("b")
    ran = []
    with annotate("serve.frame", unit):
        with annotate("serve.copy"):
            ran.append(1)
    with pytest.raises(KeyError):
        with annotate("serve.frame", unit):
            raise KeyError("goes through")
    assert ran == [1] and spans() == [] and span_totals("serve.frame") == (0, 0)


def test_a_span_without_a_profiler_costs_a_bare_with_statement():
    # best of 7 rounds of 20,000: under 0.5 us a span, or on a slower host
    # than that allows, no more than twice a with-statement that does
    # nothing
    def per_call(make):
        best = float("inf")
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(20_000):
                with make():
                    pass
            best = min(best, (time.perf_counter() - t0) / 20_000)
        return best

    bare = _NoOp()
    off = per_call(lambda: annotate("train.step", 3))
    assert off <= max(0.5e-6, 2.0 * per_call(lambda: bare)), off


def _user_annotations(prof, tmp_path):
    path = str(tmp_path / "spans.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"]: e for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"}


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_spans_land_in_the_table_and_the_chrome_trace(tmp_path, nested):
    # each span is one record of the table and one user_annotation of the
    # trace; durations agree within 50 us + 5 %; parents hold their children
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("t.root", 3):
            with annotate("t.a"):
                time.sleep(0.004)
                if nested:
                    with annotate("t.b"):
                        time.sleep(0.003)
            with annotate("t.c"):
                time.sleep(0.002)
    names = ["t.a", "t.c", "t.root"] + (["t.b"] if nested else [])
    table = {s.name: s for s in spans()}
    assert sorted(table) == sorted(names) and len(spans()) == len(names)
    trace_events = _user_annotations(prof, tmp_path)
    for name in names:
        span, event = table[name], trace_events[name]
        got_us = (span.end_ns - span.start_ns) / 1e3
        assert abs(float(event["dur"]) - got_us) <= 50.0 + 0.05 * got_us, name
    children = {"t.root": ["t.a", "t.c"], "t.a": ["t.b"] if nested else []}
    for parent, kids in children.items():
        for kid in kids:
            assert table[kid].parent == table[parent].id
            assert table[parent].start_ns <= table[kid].start_ns
            assert table[kid].end_ns <= table[parent].end_ns
            outer, inner = trace_events[parent], trace_events[kid]
            assert float(outer["ts"]) <= float(inner["ts"])
            assert (float(inner["ts"]) + float(inner["dur"])
                    <= float(outer["ts"]) + float(outer["dur"]))
    assert table["t.root"].parent is None


def test_self_time_excludes_the_child_spans():
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with annotate("s.outer"):
                time.sleep(0.002)
                with annotate("s.inner"):
                    time.sleep(0.005)
    outer = [s for s in spans() if s.name == "s.outer"]
    inner = [s for s in spans() if s.name == "s.inner"]
    assert len(outer) == len(inner) == 2
    for o, i in zip(outer, inner):
        assert o.child_ns == i.end_ns - i.start_ns
        assert o.self_ns == o.end_ns - o.start_ns - o.child_ns
        assert o.self_ns >= 1_900_000 and i.self_ns >= 4_900_000
    assert span_totals("s.outer") == (2, sum(o.self_ns for o in outer))
    assert span_totals("s.inner") == (2, sum(i.self_ns for i in inner))
    assert span_totals("s.none") == (0, 0)


@pytest.mark.parametrize("unit", [0, 5, None])
def test_the_unit_id_is_the_root_span_s(unit):
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with annotate("u.root", unit):
            with annotate("u.child"):
                with annotate("u.grandchild"):
                    pass
        with annotate("u.other", 11):
            with annotate("u.its_child"):
                pass
    got = {s.name: s.unit for s in spans()}
    assert got == {"u.root": unit, "u.child": unit, "u.grandchild": unit,
                   "u.other": 11, "u.its_child": 11}


def test_the_table_drops_its_oldest_spans_past_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "TABLE", SpanTable(4))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(7):
            with annotate(f"d.{i}", i):
                pass
    assert [s.name for s in spans()] == ["d.3", "d.4", "d.5", "d.6"]
    assert profiling.TABLE.dropped == 3
    clear_spans()
    assert spans() == [] and profiling.TABLE.dropped == 0


def test_spans_of_many_threads_keep_their_own_parents():
    # 16 threads, 50 roots each with a child, the interpreter switching
    # threads every few microseconds: every span is kept, and each child's
    # parent is its own thread's root
    clear_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(50):
                with annotate(f"m.root.{k}", i):
                    with annotate(f"m.child.{k}"):
                        pass

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    records = spans()
    assert len(records) == 16 * 100 and len({s.id for s in records}) == 1600
    by_id = {s.id: s for s in records}
    for s in records:
        if ".child." in s.name:
            root = by_id[s.parent]
            assert root.name == s.name.replace("child", "root") and root.unit == s.unit


def test_op_breakdown_gives_the_host_self_ms_of_each_span(capsys):
    # the window's own spans, a call's: the stale record left before it
    # is dropped when the window opens
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with annotate("stale"):
            pass
    fn, x = _conv_matmul()

    def slow(x):
        with annotate("sleeper"):
            time.sleep(0.003)
            return fn(x)

    result = op_breakdown(slow, x, steps=2, warmup=1)
    assert sorted(result.spans) == ["conv_then_matmul", "sleeper"]
    assert 2.9 <= result.spans["sleeper"] < result.host_ms
    assert 0 < result.spans["conv_then_matmul"] < result.host_ms
    assert "sleeper" not in result and span_totals("sleeper")[0] == 2
    out = capsys.readouterr().out
    assert "ms/step host self  sleeper" in out and "conv_then_matmul" in out
    assert "stale" not in out
