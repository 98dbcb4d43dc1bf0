"""Host ms a served frame in `pseudolidar.copy_out` (serve loop layer): the
copies of depth, points and mask from the card to pageable host memory.

The self time of the program's `pseudolidar.copy_out` spans
(unsupervised_pseuso_lidar_tpu_torch/utils/profiling.py, recorded only
under a profiler, so in the traced slice alone) over the slice's frames
(units × the batch of cameras). None without a slice, or where the
program recorded another number of these spans than one a unit (a program
without the span)."""

SPAN = "pseudolidar.copy_out"


def read(run):
    try:
        from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    s, batch = run.slice, run.facts.get("shapes", {}).get("batch")
    if s is None or not s.units or not batch:
        return None
    count, self_ns = span_totals(SPAN)
    if count != s.units:
        return None
    return self_ns / 1e6 / (s.units * batch)
