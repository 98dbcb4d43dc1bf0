"""The end-to-end arithmetic: a rate over a window and a tail over all
of its requests.

Both are taken over the whole window, never from medians of chunks of it,
so a stall inside the window moves them.
"""

from __future__ import annotations

import math
from typing import Sequence


def rate(units: float, seconds: float) -> float:
    """Work completed per second of the whole window."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of every value, linearly interpolated
    between the two nearest ranks (numpy's default)."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    pos = (len(ordered) - 1) * q / 100.0
    low = math.floor(pos)
    high = min(low + 1, len(ordered) - 1)
    return ordered[low] + (ordered[high] - ordered[low]) * (pos - low)

