"""Kernels A and A' (ops/cuda/warp_bilinear.cu): their least time by the
roofline over their device time in the traced steps, %."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, ("warp_bilinear_fwd", "warp_bilinear_bwd_grid"))
