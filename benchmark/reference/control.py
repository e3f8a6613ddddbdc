"""The control of the comparison, and the faults it has to catch, as
answers put in the program's place.

The control is the reference with one stated guarantee broken, each
the step a later change to the kernels could be tempted by; everything
else is the reference's (the queue, filters, scores and capacity
search):

- `tie_last`: the configurations state the simulator's deterministic
  tie rule (selectHost takes the first node of the highest score in
  node order); the control takes the last one, as an unordered parallel
  arg-max on the card might. It is spread-deploy's control. In
  basic-plan every node of the answer ends alike (40 pods of one
  Deployment), so no tie rule shows there;
- `fit_strict`: every pod must pass NodeResourcesFit, which admits a
  pod while its requests and the node's sum to at most its allocatable;
  the control admits it only below (`<` for `<=`), as a kernel's
  comparison written the other way might. It is basic-plan's control.

The faults give the numbers the control leaves at 0 their upper
readings, each planted in the reference's own answer:

- `half_left_out`: half of each workload's pods left out of the plan;
- `count_off`: the count one below the least (one above where the least
  is 0), with its placement;
- `state_unchanged`: every node's reported allocation left as it was
  before the request.

    python3 -m benchmark.reference.control --workload <name> --seeds <n> [<n> ...]

prints, for each seed and each of them, the numbers `check.compare`
gives it against the reference on the seed's first request, at the
cell's own size.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

from .. import cells, check, generate
from . import kube_v120


def tie_last(inst):
    return kube_v120.plan(inst, tie="last")


class _StrictFit(kube_v120.Cluster):
    def score(self, shape, j):
        rc, rm, _ = shape
        if self.used_cpu[j] + rc >= self.cpu[j] or self.used_mem[j] + rm >= self.mem[j]:
            return -1
        return super().score(shape, j)


def fit_strict(inst):
    return kube_v120.plan(inst, cluster=_StrictFit)


def half_left_out(inst):
    half = copy.deepcopy(inst)
    for w in half.workloads:
        w.replicas //= 2
    return kube_v120.plan(half)


def count_off(inst):
    best = kube_v120.plan(inst)
    return kube_v120.schedule(inst, best.count - 1 if best.count > 0 else 1)


def state_unchanged(inst):
    ans = kube_v120.plan(inst)
    ans.cpu_req = np.zeros_like(ans.cpu_req)
    ans.mem_req = np.zeros_like(ans.mem_req)
    ans.pod_count = np.zeros_like(ans.pod_count)
    return ans


VARIANTS = {"tie_last": tie_last, "fit_strict": fit_strict, "half_left_out": half_left_out,
            "count_off": count_off, "state_unchanged": state_unchanged}


def readings(cell: cells.Cell, seed: int, variant: str = "tie_last", index: int = 0) -> dict:
    inst = generate.make_instance(cell.config, cell.traffic, seed, index)
    ref = check.Reference(kube_v120.schedule)
    return check.compare(VARIANTS[variant](inst), inst, ref.at(inst))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.reference.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=sorted(VARIANTS), choices=sorted(VARIANTS))
    args = p.parse_args(argv)
    cell = cells.load_cell(os.getcwd(), args.workload)
    for seed in args.seeds:
        for variant in args.variants:
            t0 = time.perf_counter()
            nums = readings(cell, seed, variant)
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                              "numbers": nums, "seconds": round(time.perf_counter() - t0, 3)}),
                  file=sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
