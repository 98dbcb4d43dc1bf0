"""Read a cell's compared numbers over many seeds, for the program and for
its control, in one process: what the limits in limits/<cell>.json are
set from.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 ... \\
        [--control-seeds 21 22 ...] [--seconds 2] [--out readings.jsonl]

Each seed runs the cell's driver once with a short window at the cell's
own sizes and load. The control runs the program's own path in the
precision below the configuration's (bf16: the configuration states fp32
with cuDNN's TF32), which the limits must fail. One JSON line a run:
{workload, seed, control, checks {name: value}, correct}. Needs the card
(the drivers' CPU runs are for the tests).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import device as dev  # noqa: E402
from portbench.core import spec  # noqa: E402


def readings(workload: str, seeds, control: bool, seconds: float, device=None,
             cell=None):
    """Yield one record a seed (module docstring)."""
    import torch

    cell = cell or spec.load_cell(workload)
    device = device or torch.device("cuda", 0)
    driver = spec.driver(cell)
    for seed in seeds:
        outcome = driver.run(cell, seed, seconds, False, device, time.perf_counter(),
                             control=control)
        dev.free(device)
        yield {"workload": cell.name, "seed": seed, "control": control,
               "checks": {k: v if math.isfinite(v) else str(v)
                          for k, (v, _) in outcome.checks.items()},
               "correct": outcome.correct}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    dev.set_cache_dirs(ROOT)
    dev.require_cards(spec.load_cell(args.workload).chips)
    out = open(args.out, "a") if args.out else None
    try:
        for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
            for record in readings(args.workload, seeds, control, args.seconds):
                line = json.dumps(record)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
