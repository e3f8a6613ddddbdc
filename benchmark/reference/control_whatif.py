"""The controls of the what-ifs' comparison: the reference with one
stated guarantee broken, in the program's place.

- `shared`: no what-if may see another's pods; the control places a
  round's what-ifs one after another on one state, as a tick whose rows
  committed into each other would, so each caller after the first
  finds the earlier callers' pods on the nodes;
- `tie_last`: selectHost takes the first node of the highest score; the
  control takes the last one, as an unordered parallel arg-max might
  (benchmark/reference/control.py's `tie_last`).

    python3 -m benchmark.reference.control_whatif --workload <name> --seeds <n> [<n> ...]

prints, for each seed and each control, the numbers
`check_whatif.compare` gives the control's answers against the
reference's over the seed's first round, at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .. import cells, check_whatif, generate_whatif
from . import kube_v120_whatif


def shared(cluster, rnd) -> list:
    committed = kube_v120_whatif.Committed(cluster)
    state = committed.fresh()
    return [committed.place(inst, state=state) for inst in rnd.whatifs]


def tie_last(cluster, rnd) -> list:
    committed = kube_v120_whatif.Committed(cluster, tie="last")
    return [committed.place(inst) for inst in rnd.whatifs]


VARIANTS = {"shared": shared, "tie_last": tie_last}


def readings(cell: cells.Cell, seed: int, variant: str, index: int = 0) -> dict:
    cluster = generate_whatif.make_cluster(cell.config, seed)
    rnd = generate_whatif.make_round(cluster, cell.traffic, seed, index)
    committed = kube_v120_whatif.Committed(cluster)
    totals = {k: 0 for k in check_whatif.LIMITS}
    for inst, ans in zip(rnd.whatifs, VARIANTS[variant](cluster, rnd)):
        for k, v in check_whatif.compare(ans, committed.place(inst)).items():
            totals[k] += v
    return totals


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.reference.control_whatif")
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
