#!/usr/bin/env python3
"""Time the fused scan's scenario batch of the GPU port on one CUDA card:
many scenarios of chip_smoke.py's default scenario (10,000 nodes x 20,000
pods) in one launch, the shape of a capacity sweep over every candidate
node count, at the wrapper's own cluster size and at each size given.

    python tools/scan_batch_waves.py [--scenarios 101] [--clusters 1,2,8,16]

Scenario k of S masks off the last S - 1 - k nodes. Prints the card
(nvidia-smi name and power limit), one line a run, and a JSON line with
every time in ms by CUDA events: `rule` (run_fused_scan_batch and the
cluster size it chose), `single` (run_fused_scan on the first scenario)
and, where the wrapper has the private launcher, `at` (each given size;
each run's placements and final rows must equal the rule's run).

It imports the port and chip_smoke.py from the tree it sits in, so that
copied into an older checkout's tools/ it times that checkout's kernel
(the private launcher and the cluster sizes are then skipped where that
checkout lacks them).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenarios", type=int, default=101)
    ap.add_argument("--clusters", default="1,2,8,16")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scan_batch_waves: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils import nvcc

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {gpu}; tree {ROOT}", flush=True)
    nvcc.build_libraries([fused_scan.SOURCE])
    nodes, pods = chip_smoke.build_scenario()
    plan, batch, names = chip_smoke.encode(nodes, pods, "cuda")
    p, n, s_n = len(names), plan.n, args.scenarios
    cls, pin = batch.class_of_pod, batch.pinned_node
    scenarios = []
    for k in range(s_n):
        valid = np.ones(n, bool)
        valid[n - (s_n - 1 - k):] = False
        scenarios.append((np.ones(p, bool), valid, pin))
    clusters = getattr(fused_scan, "CLUSTERS", {})

    fused_scan.run_fused_scan_batch(plan, cls, chip_smoke.prefix(scenarios[:2], 10))  # warm
    want, rule_ms = chip_smoke.cuda_ms(lambda: fused_scan.run_fused_scan_batch(
        plan, cls, scenarios))
    out = {"scenarios": s_n, "nodes": n, "pods": p, "rule": rule_ms,
           "rule_cluster": clusters.get(fused_scan.BATCH_KERNEL_NAME)}
    print(f"{s_n} scenarios, the wrapper's cluster size {out['rule_cluster']}: "
          f"{rule_ms:.3f} ms [{gpu}]", flush=True)
    _, out["single"] = chip_smoke.cuda_ms(lambda: fused_scan.run_fused_scan(
        plan, cls, *scenarios[0][:2], pinned=pin))
    print(f"1 scenario, run_fused_scan: {out['single']:.3f} ms [{gpu}]", flush=True)
    if hasattr(fused_scan, "_run_with_cluster"):
        out["at"] = {}
        for c in (int(x) for x in args.clusters.split(",")):
            def run():
                return fused_scan._run_with_cluster(plan, cls, scenarios, True, c)
            fused_scan._run_with_cluster(plan, cls, chip_smoke.prefix(scenarios[:2], 10),
                                         True, c)  # warm: the attribute calls of a size
            got, ms = chip_smoke.cuda_ms(run)
            err = max(chip_smoke.max_abs_err(g, w) for g, w in zip(got, want))
            if err:
                raise AssertionError(f"cluster {c}: != the rule's run ({err})")
            active = fused_scan.max_active_clusters(plan, s_n, True, c)
            out["at"][c] = {"ms": ms, "resident_clusters": active,
                            "waves": -(-s_n // max(active, 1))}
            print(f"{s_n} scenarios on clusters of {c} ({active} resident at once, "
                  f"{out['at'][c]['waves']} waves): {ms:.3f} ms, == the rule's run [{gpu}]",
                  flush=True)
    print(gpu)
    print(json.dumps({"scan_batch_waves": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
