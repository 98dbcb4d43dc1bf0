"""GiB in the segments of the training step's CUDA graph pool
(StepGraphs.pool) after the capture (trainer / graph layer)."""

from portbench.core import readers


def read(run):
    return readers.pool_gib(run)
