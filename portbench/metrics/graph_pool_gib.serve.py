"""GiB in the segments of the serving pipeline's CUDA graph pool after the
capture (serve loop layer)."""

from portbench.core import readers


def read(run):
    return readers.pool_gib(run)
