"""Kernels B and C (ops/cuda/ssim.cu, ssim_bwd.cu): their least time by the
roofline over their device time in the traced steps, %."""

from portbench.core import readers


def read(run):
    return readers.roofline(run, ("ssim_fwd", "ssim_bwd"))
