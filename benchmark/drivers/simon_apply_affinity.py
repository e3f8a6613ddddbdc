"""The driver of `simon apply` traffic whose pods carry inter-pod
affinity of every kind: `simon_apply`'s requests, sent and judged as it
does, made by benchmark/generate_affinity.py, and each answer's scan
bound from the count that adds these terms' rows and work
(benchmark/cost/fused_scan_affinity.py)."""

from __future__ import annotations

import importlib
import os

from benchmark import cells, check, generate_affinity
from benchmark.cost import fused_scan_affinity as cost
from benchmark.drivers import simon_apply

LIMITS = check.LIMITS


class Driver(simon_apply.Driver):
    def __init__(self, cell, seed: int, tmp: str, device=None):
        self.device = device
        self.warm = generate_affinity.make_instance(cell.config, cell.traffic, seed, -1)
        self.ring = [generate_affinity.make_instance(cell.config, cell.traffic, seed, i)
                     for i in range(int(cell.traffic["ring"]))]
        self.paths = {inst.tag: inst.write(os.path.join(tmp, inst.tag))
                      for inst in [self.warm] + self.ring}
        self.reference = check.Reference(cells.load_reference(cell.config))
        self.cli = importlib.import_module("open_simulator_tpu_torch.cli")

    def judge(self, inst, text: str) -> tuple:
        numbers, facts = super().judge(inst, text)
        if "count" in facts:
            facts["scan_bound_ms"] = cost.bound(inst, facts["count"])[0]
        return numbers, facts
