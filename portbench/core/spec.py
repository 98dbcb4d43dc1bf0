"""The benchmark's data, found by name.

`BENCHMARK.json` at the checkout's root lists the cells, configurations
and metrics. Everything that belongs to one of them is a file of its own
under `portbench/`, named after it:

- a configuration: `configs/<config>.json` (the file that BENCHMARK.json
  names); the models it names (a served model's `model.name`, a trained
  one's `trainer.model.depth.name` and `.pose.name`, the program's
  registry names) pick both the program's model, built from the keyword
  arguments the file gives it, and the plain reference of that name;
- a model's plain reference: `reference/nets/<model>.py`, with
  `build(kwargs, image_shape) -> nn.Module` (its interface in
  reference/nets/BtsModel.py);
- a traffic mix: `traffic/<traffic>.json`, whose "driver" names the
  general driver that runs it (`drivers/<driver>.py`);
- the limits of a cell's correctness comparison: `limits/<cell>.json`;
- a per-layer metric: `metrics/<metric>.py`, a reader with
  `read(run) -> float | None`;
- a kernel's roofline: `rooflines/<kernel>.py` (its interface in
  rooflines/warp_bilinear_fwd.py);
- the peaks of a device: `peaks.json`.

A later change adds a cell, a configuration or a metric by adding files
and entries; no existing file needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PACKAGE_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, prefix: str) -> ModuleType:
    """Import the Python file at `path` under a name of its own."""
    name = prefix + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json`, its configuration,
    traffic and limits, and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[work["config"]]["file"]))
    traffic = load_json(os.path.join(PACKAGE_DIR, "traffic", f"{work['traffic']}.json"))
    limits = load_json(os.path.join(PACKAGE_DIR, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, int(work["chips"]), config, traffic, limits, e2e, per_layer)


def driver(cell: Cell) -> ModuleType:
    """The driver module that runs the cell's traffic (`portbench.drivers`)."""
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def reference_net(name: str) -> ModuleType:
    """The plain reference of the program's model `name`."""
    path = os.path.join(PACKAGE_DIR, "reference", "nets", f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no plain reference for the model {name!r}: add {path}")
    return load_module(path, "portbench_net_")


def metric_reader(name: str) -> ModuleType:
    return load_module(os.path.join(PACKAGE_DIR, "metrics", f"{name}.py"), "portbench_metric_")


def roofline(kernel: str) -> ModuleType:
    return load_module(os.path.join(PACKAGE_DIR, "rooflines", f"{kernel}.py"),
                       "portbench_roofline_")


def peaks() -> Dict[str, dict]:
    return load_json(os.path.join(PACKAGE_DIR, "peaks.json"))
