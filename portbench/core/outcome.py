"""What a driver hands back to the harness, and the checks of `correct`."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from portbench.core.trace import TraceSlice


@dataclass
class Outcome:
    """One run of a cell.

    end_to_end: the end-to-end metrics the driver measured, by name.
    attempted / failed: the units (steps, frames) the window attempted and
      those that failed.
    peak_bytes: the card's peak reserved memory over set-up and window.
    slice: the traced slice (--trace 1), else None.
    facts: what the per-layer readers need besides the trace: the unit's
      model FLOPs, the peak of the configuration's precision, the graph
      pool's bytes, the cell's shapes.
    checks: {name: (value, limit)}: the numbers compared with the
      reference; the run is correct when each is finite and within its
      limit.
    """

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    slice: Optional[TraceSlice] = None
    facts: Dict = field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            math.isfinite(value) and value <= limit for value, limit in self.checks.values())


def checks_from(values: Dict[str, float],
                limits: Dict[str, float]) -> Dict[str, Tuple[float, float]]:
    """Pair each compared number with its limit; a limit without a number
    (the comparison did not run) reads as infinitely far."""
    return {name: (float(values.get(name, math.inf)), float(limit))
            for name, limit in limits.items()}
