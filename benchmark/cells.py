"""Finding a cell's parts by name: `BENCHMARK.json` at the checkout's
root names the cell's configuration and traffic mix and lists its
metrics; each part is a file of its own that a later change adds
without editing one that is there:

- a configuration: the `file` its entry in `configs` names;
- a traffic mix: `benchmark/traffic/<traffic>.json`, which names its
  driver, the code that makes, sends and judges its kind of request:
  `benchmark/drivers/<driver>.py`, whose `Driver` and `LIMITS` the run
  takes;
- a metric: `benchmark/metrics/<name>.py`, whose `read(run)` gives the
  value;
- a configuration's plain reference: `benchmark/reference/<reference>.py`
  (the configuration's `reference` key).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

MANIFEST = "BENCHMARK.json"
PACKAGE = "benchmark"


@dataclass
class Metric:
    name: str
    unit: str
    per_layer: bool
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[Metric]

    def metrics_for(self, trace: bool) -> List[Metric]:
        return [m for m in self.metrics if m.per_layer == trace]


class CellError(ValueError):
    """A cell or one of its parts is not where its name says."""


def load_manifest(root: str) -> dict:
    path = os.path.join(root, MANIFEST)
    if not os.path.isfile(path):
        raise CellError(f"no {MANIFEST} at {root}")
    with open(path) as f:
        return json.load(f)


def _load_file(root: str, part: str, name: str):
    """The module `benchmark/<part>/<name>.py` under `root`."""
    path = os.path.join(root, PACKAGE, part, f"{name}.py")
    if not os.path.isfile(path):
        raise CellError(f"{part} {name!r} has no file at {path}")
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_{part}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root: str, name: str) -> Callable:
    return _load_file(root, "metrics", name).read


def load_driver(root: str, cell: "Cell"):
    """The module that drives the cell's kind of request."""
    return _load_file(root, "drivers", cell.traffic["driver"])


def load_reference(config: dict) -> Callable:
    """The `schedule(instance, count)` of the configuration's reference."""
    module = importlib.import_module(f"{PACKAGE}.reference.{config['reference']}")
    return module.schedule


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise CellError(f"no workload {workload!r} in {MANIFEST}")
    conf = next((c for c in manifest["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise CellError(f"workload {workload!r} names no configuration in {MANIFEST}")
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    traffic_path = os.path.join(root, PACKAGE, "traffic", f"{entry['traffic']}.json")
    if not os.path.isfile(traffic_path):
        raise CellError(f"traffic {entry['traffic']!r} has no file at {traffic_path}")
    with open(traffic_path) as f:
        traffic = json.load(f)
    metrics: List[Metric] = []
    for key, per_layer in (("end_to_end", False), ("per_layer", True)):
        for m in manifest.get(key, []):
            if _applies(m, workload):
                metrics.append(Metric(m["name"], m["unit"], per_layer,
                                      load_reader(root, m["name"])))
    return Cell(name=workload, chips=int(entry["chips"]), config=config, traffic=traffic,
                metrics=metrics)


def metric_values(cell: Cell, run, trace: bool) -> Dict[str, dict]:
    """The line's metrics: each reader's value with its unit, leaving
    out a metric whose reader found nothing."""
    out = {}
    for m in cell.metrics_for(trace):
        v = m.read(run)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out
