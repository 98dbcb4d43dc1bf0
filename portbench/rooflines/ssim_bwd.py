"""Kernel C, the SSIM + L1 backward (ops/cuda/ssim_bwd.cu,
`ssim_bwd_kernel`): one launch a step in the 'min' objective, the warped
jobs' 3 * batch images of 3 channels, the gradient of the warped side only
(the targets are data).

Bytes: a pixel of a channel reads x, y and the cotangent (12 B) and writes
dx (4 B). Operations: 64 to recompute the moments and the ratio, 40 for
the ratio's partials, 40 for the adjoint box passes, 6 for the L1 term.
Interface: see warp_bilinear_fwd.py.
"""

FAMILY = "ssim_bwd_kernel"
PRECISION = "fp32_flops_per_s"


def launches(shapes):
    return 1


def work(shapes):
    planes = 3 * shapes["batch"] * 3 * shapes["height"] * shapes["width"]
    return 12 * planes, 4 * planes, 150 * planes
