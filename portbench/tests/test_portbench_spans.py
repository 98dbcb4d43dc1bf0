"""CPU tests of the per-layer readers of the program's spans
(metrics/compact_ms.serve.py, copy_out_ms.serve.py, wait_ms.serve.py,
copy_in_ms.train.py): hand-filled span tables, the ms a frame or a step
they give, and the runs they leave silent."""

from __future__ import annotations

import pytest

from portbench.core import spec
from portbench.core.outcome import Outcome
from portbench.core.trace import TraceSlice
from unsupervised_pseuso_lidar_tpu_torch.utils import profiling
from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import Span, SpanTable

# reader -> (its span, whether it divides by the cell's batch of cameras)
READERS = {
    "compact_ms.serve": ("pseudolidar.compact", True),
    "copy_out_ms.serve": ("pseudolidar.copy_out", True),
    "wait_ms.serve": ("pseudolidar.wait", True),
    "copy_in_ms.train": ("graph.copy_in", False),
}


def _slice(units):
    return TraceSlice(units, 1000.0, 500.0, [], {}, {})


def _run(units, batch=1):
    run = Outcome({}, units, 0, 0, slice=_slice(units))
    run.facts["shapes"] = {"batch": batch, "height": 8, "width": 8}
    return run


@pytest.fixture
def table(monkeypatch):
    """An empty span table in the program's place."""
    fresh = SpanTable()
    monkeypatch.setattr(profiling, "TABLE", fresh)
    return fresh


def _fill(table, name, units, self_ns, child_ns=0):
    """`units` spans named `name` under roots of another name, each of
    `self_ns` own time and `child_ns` in a child."""
    for unit in range(units):
        start = 1_000_000 * unit
        end = start + self_ns + child_ns
        table.add(Span("child", start, start + child_ns, 0, 3 * unit + 2, 3 * unit + 1, unit))
        table.add(Span(name, start, end, child_ns, 3 * unit + 1, 3 * unit, unit))
        table.add(Span("root", start, end + 5_000, end - start, 3 * unit, None, unit))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name", sorted(READERS))
def test_a_span_reader_gives_self_ms_a_frame_or_a_step(table, name, batch):
    # 4 units, each span 1.5 ms of its own and 0.5 ms in a child: 1.5 ms a
    # step, or 1.5 / batch ms a frame
    span, per_frame = READERS[name]
    _fill(table, span, 4, 1_500_000, 500_000)
    got = spec.metric_reader(name).read(_run(4, batch))
    assert got == pytest.approx(1.5 / batch if per_frame else 1.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_span_reader_is_silent_without_a_slice_or_one_span_a_unit(table, name,
                                                                    monkeypatch):
    span, _ = READERS[name]
    reader = spec.metric_reader(name)
    _fill(table, span, 4, 1_000_000)
    assert reader.read(Outcome({}, 0, 0, 0)) is None
    assert reader.read(_run(0)) is None
    assert reader.read(_run(3)) is None and reader.read(_run(5)) is None
    assert reader.read(_run(4)) == pytest.approx(1.0)
    table.clear()
    assert reader.read(_run(4)) is None
    # a program without the span table, as the commits before it
    _fill(table, span, 4, 1_000_000)
    monkeypatch.delattr(profiling, "span_totals")
    assert reader.read(_run(4)) is None
