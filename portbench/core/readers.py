"""What the per-layer readers (metrics/<name>.py) share.

Each reader takes the run's Outcome and returns a number, or None where
the run holds nothing to read (no traced slice, no pool, a kernel that did
not run as its roofline file expects): the harness then leaves the metric
out of the result line. No share of a roofline or a peak is ever clipped.
"""

from __future__ import annotations

from typing import Optional, Sequence

from portbench.core import spec
from portbench.core.outcome import Outcome

# words of the op families (core/trace.op_family) of the convolutions:
# chip_smoke.CONV_WORDS (cuDNN's and cuBLAS's convolution and GEMM kernels,
# the FFT convolutions' transforms, the layout conversions around them),
# and cuDNN's Winograd transforms and cuBLASLt's split-K reductions. The
# few small GEMMs of PoseFc's Linear layers and the projector's einsum fall
# in too; cuDNN's BatchNorm kernels (cudnn::bn_*) do not.
CONV_WORDS = ("conv", "fft", "fprop", "dgrad", "wgrad", "xmma", "gemm", "cutlass",
              "pointwise_mult_and_sum_complex", "nchwtonhwc", "nhwctonchw", "winograd",
              "splitkreduce")


def is_conv(family: str) -> bool:
    name = family.lower()
    return any(word in name for word in CONV_WORDS)


def idle_share(run: Outcome) -> Optional[float]:
    """% of the traced slice in which no operation ran on the device."""
    s = run.slice
    if s is None or s.window_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)


def mfu(run: Outcome) -> Optional[float]:
    """% of the configuration's peak: model FLOPs of the slice's units over
    the slice's length."""
    s = run.slice
    flops, peak = run.facts.get("flops_per_unit"), run.facts.get("peak_flops")
    if s is None or not flops or not peak or s.window_us <= 0:
        return None
    return 100.0 * flops * s.units / (s.window_us * 1e-6) / peak


def conv_ms(run: Outcome) -> Optional[float]:
    """Device ms a unit in the convolution families."""
    s = run.slice
    if s is None or not s.units:
        return None
    us = sum(v for fam, v in s.family_us.items() if is_conv(fam))
    return us / s.units / 1e3 if us else None


def pool_gib(run: Outcome) -> Optional[float]:
    """GiB in the segments of the timed graphs' private memory pool."""
    pool = run.facts.get("pool_bytes")
    return pool / 2 ** 30 if pool else None


def roofline(run: Outcome, kernels: Sequence[str]) -> Optional[float]:
    """% of the least time the card could take for `kernels`' work (each
    rooflines/<kernel>.py: bytes and operations a unit at the cell's
    shapes, and its launches a unit) over their device time in the slice.
    None where a kernel did not run, or ran another number of times than
    its file counts for."""
    s = run.slice
    shapes = run.facts.get("shapes")
    peaks = run.facts.get("peaks")
    if s is None or shapes is None or peaks is None or not s.units:
        return None
    bound_s = device_s = 0.0
    for name in kernels:
        kernel = spec.roofline(name)
        launches = kernel.launches(shapes)
        if s.family_counts.get(kernel.FAMILY, 0) != launches * s.units:
            return None
        read, written, ops = kernel.work(shapes)
        bound_s += s.units * max((read + written) / peaks["hbm_bytes_per_s"],
                                 ops / peaks[kernel.PRECISION])
        device_s += s.kernel_us(kernel.FAMILY) * 1e-6
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
