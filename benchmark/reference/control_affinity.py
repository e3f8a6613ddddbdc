"""The control of the comparison for requests with inter-pod affinity:
`kube_v120_affinity` with one stated guarantee broken, everything else
its own (the queue, the filters, the other scores, the capacity search).

- `bounds_from_feasible`: the configuration states InterPodAffinity's
  NormalizeScore with max and min starting at 0; the control takes
  them from the feasible nodes' raw scores alone, as a kernel's
  min-max reduction seeded from its first node might. Where every
  feasible node scores above 0 (the placed required-affinity pods lift
  every node of their zone), the control stretches the difference
  between the nodes to the whole range.

    python3 -m benchmark.reference.control_affinity --workload <name> --seeds <n> [<n> ...]

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

import numpy as np

from .. import cells, check, generate_affinity
from . import kube_v120_affinity as reference


def normalize_from_feasible(raw: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """NormalizeScore with its bounds from the feasible nodes alone."""
    if not feasible.any():
        return np.zeros_like(raw)
    hi, lo = int(raw[feasible].max()), int(raw[feasible].min())
    if hi == lo:
        return np.zeros_like(raw)
    return (float(reference.MAX_SCORE) * ((raw - lo) / float(hi - lo))).astype(np.int64)


def bounds_from_feasible(inst):
    return reference.plan(inst, normalizer=normalize_from_feasible)


VARIANTS = {"bounds_from_feasible": bounds_from_feasible}


def readings(cell: cells.Cell, seed: int, variant: str = "bounds_from_feasible",
             index: int = 0) -> dict:
    inst = generate_affinity.make_instance(cell.config, cell.traffic, seed, index)
    ref = check.Reference(reference.schedule)
    return check.compare(VARIANTS[variant](inst), inst, ref.at(inst))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.reference.control_affinity")
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
