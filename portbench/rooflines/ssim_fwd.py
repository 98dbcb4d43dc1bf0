"""Kernel B, the 3x3 reflection-padded SSIM distance blended with L1
(ops/cuda/ssim.cu, `ssim_fwd_kernel`), in the 'min' objective: one launch
a step for the identity pair over 2 * batch images, and one for each of
the depth net's outputs over its 3 * batch warped jobs, each image of 3
channels.

Bytes: a pixel of a channel reads x and y (8 B) and writes the error
(4 B). Operations: 40 for the five 3x3 box means (two passes of 2 sums and
a division each), 20 for the SSIM ratio and clamp, 4 for the blend.
Interface: see warp_bilinear_fwd.py.
"""

FAMILY = "ssim_fwd_kernel"
PRECISION = "fp32_flops_per_s"


def launches(shapes):
    return 1 + shapes.get("outputs", 1)


def work(shapes):
    images = (2 + 3 * shapes.get("outputs", 1)) * shapes["batch"]
    planes = images * 3 * shapes["height"] * shapes["width"]
    return 8 * planes, 4 * planes, 64 * planes
