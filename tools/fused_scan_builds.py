#!/usr/bin/env python3
"""Time several builds of the GPU port's fused-scan source against each
other in one process on one CUDA card:

    python tools/fused_scan_builds.py OLD.cu NEW.cu [MORE.cu ...] [--repeats 3]

Each source is compiled like open_simulator_tpu_torch/csrc/fused_scan.cu
(utils/nvcc.py, all compilers started together) and loaded beside the
others; the wrapper is pointed at each library in turn, forward and then
backward over the sources, so that every build runs on the same card,
plan and inputs, interleaved. Cases on chip_smoke.py's default scenario
(10,000 nodes x 20,000 pods): `b1`, one scan (B1); `b6x3`, the one-pass
batch of 3 node masks; `pf_free`, one pins-first row with every pod free;
`pf_pinned`, one pins-first row with 95% of the pods pinned and the rest
inactive; `window`, a timeline window's shape, 4 pins-first rows with 8%
of the pods active and 70% of all pods pinned. Cases on chip_smoke.py
phase 17b's launch, the outage rows recorded once from `simon chaos
--failures 2 --trials 32` on the 2,000-node capacity cut (about 2,000
rows of 20,000 pods, most of them pinned): `outage`, the launch;
`outage_pinned`, its first row with only its pinned pods active (the
pinned pass); `outage_free`, its first row with every pin cleared (every
pod a free step). Every build's placements must equal the first build's.
Times are the kernel alone (chip_smoke.kernel_ms: CUDA events around the
library's launch, not the wrapper's host work), `--repeats` a case a
visit. Prints the card (nvidia-smi name and power limit), the cases'
shapes, a line a build and a JSON line. The sources must take the
wrapper's argument vector; the wrapper is this tree's, so a build's time
is its kernel's, not an older wrapper's host work.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path):
    """A fused-scan library with the wrapper's ctypes signatures."""
    lib = ctypes.CDLL(str(path))
    lib.fused_scan_arg_count.argtypes = []
    lib.fused_scan_arg_count.restype = ctypes.c_int64
    lib.fused_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.fused_scan_launch.restype = ctypes.c_int
    lib.fused_scan_max_clusters.argtypes = [ctypes.c_int64] * 10 + [ctypes.c_void_p]
    lib.fused_scan_max_clusters.restype = ctypes.c_int
    lib.fused_scan_static_smem.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    lib.fused_scan_static_smem.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_scan_builds: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils import nvcc

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {gpu}", flush=True)
    names = [str(s) for s in args.sources]
    libs = {name: load(p) for name, p in zip(names, nvcc.build_libraries(args.sources))}
    for name, lib in libs.items():
        if lib.fused_scan_arg_count() != fused_scan._N_ARGS:
            raise SystemExit(f"{name} takes {lib.fused_scan_arg_count()} arguments, "
                             f"the wrapper passes {fused_scan._N_ARGS}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg = chip_smoke.write_capacity_config(Path(tmp), chip_smoke.CHAOS_NODES,
                                               chip_smoke.CHAOS_PODS)
        rec = chip_smoke.chaos_cli("outage", gpu, ["chaos", "-f", cfg, "--failures", "2",
                                                   "--trials", "32", "--format", "json"])
    o_plan, o_cls, outage = rec["calls"][0][:3]
    a0, v0, q0 = outage[0]
    a0, q0 = np.asarray(a0, bool), np.asarray(q0)
    o_free = float(np.mean([(np.asarray(a, bool) & (np.asarray(q) < 0)).sum()
                            for a, _, q in outage]))
    print(f"outage: {len(outage)} rows x {len(o_cls)} pods x {o_plan.n} nodes, "
          f"{o_free:.1f} free pods a row; its first row {int((a0 & (q0 >= 0)).sum())} "
          f"pinned pods, {int(a0.sum())} active", flush=True)

    nodes, pods = chip_smoke.build_scenario()
    plan, batch, _ = chip_smoke.encode(nodes, pods, "cuda")
    plan = dataclasses.replace(plan, has_pins=True)
    cls, p, n = batch.class_of_pod, len(batch.class_of_pod), plan.n
    rng = np.random.RandomState(3)
    ones_p, ones_n = np.ones(p, bool), np.ones(n, bool)
    pins = np.where(rng.rand(p) < 0.95, rng.randint(n, size=p), -1)
    rng = np.random.RandomState(14)
    window = [(rng.rand(p) < 0.08, ones_n, np.where(rng.rand(p) < 0.7, rng.randint(n, size=p),
                                                     -1)) for _ in range(4)]
    print(f"window: 4 rows x {p} pods x {n} nodes, "
          f"{np.mean([(a & (q < 0)).sum() for a, _, q in window]):.1f} free pods a row",
          flush=True)

    def pins_first(pl, c, rows):
        return lambda: fused_scan.run_fused_scan_batch(pl, c, rows, pins_first=True)

    cases = {
        "b1": lambda: [fused_scan.run_fused_scan(plan, cls, ones_p, ones_n)],
        "b6x3": lambda: fused_scan.run_fused_scan_batch(
            plan, cls, [(ones_p, np.arange(n) >= k, None) for k in (0, 10, 20)]),
        "pf_free": pins_first(plan, cls, [(ones_p, ones_n, np.full(p, -1))]),
        "pf_pinned": pins_first(plan, cls, [(pins >= 0, ones_n, pins)]),
        "window": pins_first(plan, cls, window),
        "outage": pins_first(o_plan, o_cls, outage),
        "outage_pinned": pins_first(o_plan, o_cls, [(a0 & (q0 >= 0), v0, q0)]),
        "outage_free": pins_first(o_plan, o_cls, [(a0, v0, np.full_like(q0, -1))]),
    }
    first = {}
    res = {name: {c: [] for c in cases} for name in names}
    for name in names + names[::-1]:
        fused_scan._LIB = libs[name]
        for c, fn in cases.items():
            got = np.stack([out[0].cpu().numpy() for out in fn()])
            if not np.array_equal(first.setdefault(c, got), got):
                raise AssertionError(f"{name}: {c} placements differ from {names[0]}'s")
            for _ in range(args.repeats):
                res[name][c].append(chip_smoke.kernel_ms(fn)[1])
    for name in names:
        print(name, {c: [round(x, 3) for x in v] for c, v in res[name].items()},
              f"[{gpu}]", flush=True)
    print(json.dumps({"card": gpu, "kernel_ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
