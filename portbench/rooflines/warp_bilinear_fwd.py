"""Kernel A, the bilinear warp's forward (ops/cuda/warp_bilinear.cu,
`warp_bilinear_fwd_kernel`), in the 'min' objective with its backward leg:
one launch a step over 3 * batch jobs (ref0 -> tgt, ref1 -> tgt, tgt ->
ref0) of a 3-channel image.

Bytes, each input byte read once and each output byte written once: a
pixel of a job reads its grid point (8 B) and its image pixel (3 channels,
12 B) and writes 3 channels (12 B). Operations: 10 for the tap weights and
7 a channel (4 products, 3 sums).

A roofline file gives FAMILY (the kernel's op family in the trace),
PRECISION (the key of its peak in peaks.json), launches(shapes) a unit
and work(shapes) -> (bytes read, bytes written, operations) a unit, where
shapes is the cell's {"batch", "height", "width"} (portbench/drivers/).
"""

FAMILY = "warp_bilinear_fwd_kernel"
PRECISION = "fp32_flops_per_s"


def launches(shapes):
    return 1


def work(shapes):
    pixels = 3 * shapes["batch"] * shapes["height"] * shapes["width"]
    return 20 * pixels, 12 * pixels, (10 + 7 * 3) * pixels
