"""Host ms a training step in `graph.copy_in` (trainer / graph layer): the
copies of the step's inputs (the staged batch, and the host values
ident_scale and lr from pageable host memory) into the step graph's
static buffers, which read near a step's device time if they wait for the
card.

The self time of the program's `graph.copy_in` spans
(unsupervised_pseuso_lidar_tpu_torch/utils/profiling.py, recorded only
under a profiler, so in the traced slice alone) over the slice's steps.
None without a slice, or where the program recorded another number of
these spans than one a step (a program without the span)."""

SPAN = "graph.copy_in"


def read(run):
    try:
        from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    s = run.slice
    if s is None or not s.units:
        return None
    count, self_ns = span_totals(SPAN)
    if count != s.units:
        return None
    return self_ns / 1e6 / s.units
