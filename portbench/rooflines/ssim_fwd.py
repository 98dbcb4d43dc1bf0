"""Kernel B, the 3x3 reflection-padded SSIM distance blended with L1
(ops/cuda/ssim.cu, `ssim_fwd_kernel`): two launches a step in the 'min'
objective, the identity pair over 2 * batch images and the warped jobs
over 3 * batch, each of 3 channels.

Bytes: a pixel of a channel reads x and y (8 B) and writes the error
(4 B). Operations: 40 for the five 3x3 box means (two passes of 2 sums and
a division each), 20 for the SSIM ratio and clamp, 4 for the blend.
Interface: see warp_bilinear_fwd.py.
"""

FAMILY = "ssim_fwd_kernel"
PRECISION = "fp32_flops_per_s"


def launches(shapes):
    return 2


def work(shapes):
    planes = (2 + 3) * shapes["batch"] * 3 * shapes["height"] * shapes["width"]
    return 8 * planes, 4 * planes, 64 * planes
