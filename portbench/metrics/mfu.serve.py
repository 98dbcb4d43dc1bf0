"""A served frame's model FLOPs (the forward's convolutions and Linear
layers, counted on the reference model) over the traced slice's time, as
% of the configuration's precision's peak."""

from portbench.core import readers


def read(run):
    return readers.mfu(run)
