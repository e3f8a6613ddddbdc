"""The driver of `simon apply` traffic: each request is one
`simon apply -f <config>` through the port's CLI in this process.

A driver is found by the name a traffic mix gives under `driver`
(`benchmark/drivers/<driver>.py`, benchmark/cells.py) and holds
everything of its kind of request: it makes the ring of requests and
the warm-up's from the seed (benchmark/generate.py), sends one, and
after the window judges each answer against the configuration's plain
reference (benchmark/check.py), with the numbers compared and their
limits (`LIMITS`).
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os

from benchmark import cells, check, generate
from benchmark.cost import fused_scan as cost

LIMITS = check.LIMITS


class Driver:
    def __init__(self, cell, seed: int, tmp: str, device=None):
        self.device = device
        self.warm = generate.make_instance(cell.config, cell.traffic, seed, -1)
        self.ring = [generate.make_instance(cell.config, cell.traffic, seed, i)
                     for i in range(int(cell.traffic["ring"]))]
        self.paths = {inst.tag: inst.write(os.path.join(tmp, inst.tag))
                      for inst in [self.warm] + self.ring}
        self.reference = check.Reference(cells.load_reference(cell.config))
        self.cli = importlib.import_module("open_simulator_tpu_torch.cli")

    def send(self, inst) -> tuple:
        """One `simon apply` of `inst`: (answered, the text it printed)."""
        argv = ["apply", "-f", self.paths[inst.tag]]
        if self.device is not None:
            argv += ["--device", self.device]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = self.cli.main(argv)
        return rc == 0, out.getvalue()

    def judge(self, inst, text: str) -> tuple:
        """(the numbers compared, what the metrics read of the answer)."""
        try:
            ans = check.parse(text, inst)
        except (ValueError, IndexError, KeyError) as e:
            return dict(check.UNREADABLE), {"error": f"an answer that cannot be read: {e!r}"}
        numbers = check.compare(ans, inst, self.reference.at(inst))
        return numbers, {"pods": ans.placed, "count": ans.count,
                         "scan_bound_ms": cost.bound(inst, ans.count)[0]}
