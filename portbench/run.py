"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, portbench/ and the
program (`unsupervised_pseuso_lidar_tpu_torch`). The cell's driver
(portbench/drivers/) builds the program, warms up the cell's shapes,
measures `--seconds` of its traffic and checks what the timed path
produced against the plain reference (portbench/reference/). With
`--trace 0` the result holds the cell's end-to-end metrics; with
`--trace 1` a traced slice after the window gives its per-layer metrics
(portbench/metrics/), the device's busy and window seconds and the
breakdown.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, [breakdown], and last `checks`, each compared
number with its limit; the same numbers end standard error. Without CUDA
or with fewer cards than the cell asks for, and when JAX or the JAX
package was loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")

from portbench.core import device as dev  # noqa: E402

dev.set_cache_dirs(ROOT)

import torch  # noqa: E402

from portbench.core import spec  # noqa: E402
from portbench.core.outcome import Outcome  # noqa: E402


def per_layer(cell: spec.Cell, outcome: Outcome) -> dict:
    metrics = {}
    for metric in cell.per_layer:
        value = spec.metric_reader(metric["name"]).read(outcome)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return metrics


def result_line(cell: spec.Cell, outcome: Outcome, trace: bool, device: torch.device) -> dict:
    if trace:
        metrics = per_layer(cell, outcome)
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    record = dev.describe(device, cell.chips, outcome.peak_bytes)
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": record}
    if trace and outcome.slice is not None:
        record["busy_s"] = outcome.slice.busy_us / 1e6
        record["window_s"] = outcome.slice.window_us / 1e6
        out["breakdown"] = outcome.slice.breakdown()
    # a comparison that could not match reads "inf": JSON has no infinity
    out["checks"] = {name: {"value": value if math.isfinite(value) else str(value),
                            "limit": limit}
                     for name, (value, limit) in outcome.checks.items()}
    return out


def facts(cell: spec.Cell, device: torch.device) -> dict:
    """What the per-layer readers need from the benchmark's tables: the
    card's peaks and the configuration's precision's peak."""
    if device.type != "cuda":
        return {}
    peaks = spec.peaks().get(torch.cuda.get_device_name(device))
    if peaks is None:
        return {}
    return {"peaks": peaks, "peak_flops": peaks[f"{cell.config['precision']}_flops_per_s"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.load_cell(args.workload)
    try:
        dev.require_cards(cell.chips)
    except dev.NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    outcome = spec.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), device,
                                    T_START)
    outcome.facts.update(facts(cell, device))
    found = dev.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules were loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(cell, outcome, bool(args.trace), device)
    print(f"portbench: {cell.name} seed {args.seed} on {dev.power_limit()}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
