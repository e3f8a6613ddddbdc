"""The control of the comparison for plain rollouts whose nodes all end
alike (basic-deploy: 150,000 pods of one Deployment, 30 a node on 5,000
nodes), where neither the tie rule nor the strict fit moves an answer:
`kube_v120` with one stated guarantee broken, everything else its own
(the queue, the filters, the capacity search).

- `most_allocated`: the configurations state kube-scheduler v1.20.5's
  scores with simon's plugin profile, whose resource score is
  NodeResourcesLeastAllocated (the share of each resource left free);
  the control scores the share taken instead (NodeResourcesMostAllocated,
  `requested * 100 / capacity`), as a kernel's score written with the
  wrong sign of the request might. It packs: a node takes pods until its
  score falls below an empty node's, and every later node in turn, so
  thousands of nodes end fuller than the reference's and the rest empty.

    python3 -m benchmark.reference.control_packing --workload <name> --seeds <n> [<n> ...]

prints, for each seed, the numbers `check.compare` gives the control
against the reference on the seed's first request, at the cell's own
size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .. import cells, check, generate
from . import kube_v120

MAX_SCORE = kube_v120.MAX_SCORE


class _MostAllocated(kube_v120.Cluster):
    def score(self, shape, j):
        base = super().score(shape, j)
        if base < 0:
            return base
        rc, rm, _ = shape
        cpu, mem = self.cpu[j], self.mem[j]
        nzc = self.nz_cpu[j] + (rc or kube_v120.DEFAULT_MILLI_CPU)
        nzm = self.nz_mem[j] + (rm or kube_v120.DEFAULT_MEMORY)
        least_cpu = 0 if (cpu == 0 or nzc > cpu) else (cpu - nzc) * MAX_SCORE // cpu
        least_mem = 0 if (mem == 0 or nzm > mem) else (mem - nzm) * MAX_SCORE // mem
        most_cpu = 0 if (cpu == 0 or nzc > cpu) else nzc * MAX_SCORE // cpu
        most_mem = 0 if (mem == 0 or nzm > mem) else nzm * MAX_SCORE // mem
        return base - (least_cpu + least_mem) // 2 + (most_cpu + most_mem) // 2


def most_allocated(inst):
    return kube_v120.plan(inst, cluster=_MostAllocated)


VARIANTS = {"most_allocated": most_allocated}


def readings(cell: cells.Cell, seed: int, variant: str = "most_allocated",
             index: int = 0) -> dict:
    inst = generate.make_instance(cell.config, cell.traffic, seed, index)
    ref = check.Reference(kube_v120.schedule)
    return check.compare(VARIANTS[variant](inst), inst, ref.at(inst))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.reference.control_packing")
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
