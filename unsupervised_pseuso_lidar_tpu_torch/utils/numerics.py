"""Arithmetic that gives the same bits on the CPU and on the card.

PyTorch on CUDA computes `tensor / python_number` as a multiply by the
number's reciprocal (one rounding away from the quotient); on the CPU it
divides, as JAX does. Where the result steers a discontinuity — a floor in
the warp, whose coordinate gradient jumps at pixel crossings, a minimum,
a clamp's tie rule — one ulp is enough to change a gradient, so those
divisions go through `div`.
"""

from __future__ import annotations

import torch


def div(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """t / divisor as an IEEE division on every device (the divisor as a
    0-dim tensor on t's device, which no device rewrites as a multiply)."""
    return t / torch.full((), divisor, dtype=t.dtype, device=t.device)


def abs_(z: torch.Tensor) -> torch.Tensor:
    """|z| with jnp.abs' gradient rule, d|z|/dz = +1 at z >= 0. torch.abs
    gives 0 at z == 0, a tie that bf16 disparities hit on flat regions and
    that a warped pixel equal to its target hits in the L1 objectives."""
    return torch.where(z >= 0, z, -z)
