"""The 95th percentile of every frame's latency in the window, hand-off to
the return of its compacted cloud (serve loop layer, host clock). A closed
loop of one client runs at the system's capacity, where the tail swings
from run to run with the host: a per-layer reading, not an end-to-end
metric with a bound (PERF.md)."""


def read(run):
    return run.end_to_end.get("serve_latency_p95_ms")
