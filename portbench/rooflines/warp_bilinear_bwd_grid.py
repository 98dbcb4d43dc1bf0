"""Kernel A', the bilinear warp's gradient with respect to the grid
(ops/cuda/warp_bilinear.cu, `warp_bilinear_bwd_grid_kernel`): one launch a
step for each of the depth net's outputs, over the 3 * batch jobs of
kernel A's launch for that output.

Bytes: a pixel of a job reads its grid point (8 B), its image pixel (12 B)
and the output's cotangent (12 B), and writes the grid's gradient (8 B).
Operations: 10 for the tap weights and 12 a channel (the two tap
differences along x and y, and their contraction with the cotangent).
Interface: see warp_bilinear_fwd.py.
"""

FAMILY = "warp_bilinear_bwd_grid_kernel"
PRECISION = "fp32_flops_per_s"


def launches(shapes):
    return shapes.get("outputs", 1)


def work(shapes):
    pixels = launches(shapes) * 3 * shapes["batch"] * shapes["height"] * shapes["width"]
    return 32 * pixels, 8 * pixels, (10 + 12 * 3) * pixels
