#!/usr/bin/env python3
"""Smoke test of the GPU port (open_simulator_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no `ok` line):

1. build the CUDA kernels from the checkout's sources (nvcc, sm_90a) and
   print each instantiation's registers and spills;
2. B1 on the default scenario (10,000 nodes x 20,000 pods in 5 classes,
   seed 0 — every 11th node tainted, one class with a nodeSelector, one
   with tolerations): the kernel and its plain PyTorch version on the
   same plan on the card, identical placements and final int64 state;
   time both;
3. the base main path, `simulate(cluster, apps, engine="cuda")`, on that
   scenario with the launch counters at 0: the kernel ran, the trace
   names it, and all 20,000 pods were placed where phase 2's plain
   version placed them;
4. B2: (a) GPU-share at 1,000 nodes of 8 x 32 Gi devices and 10,000
   pods (4/8/16/32 Gi single-GPU and 16 Gi two-GPU asks), kernel ==
   plain including the per-device GPU rows, then `simulate(engine=
   "cuda")` on it with the counters at 0, placed as the plain version
   placed; (b) hostPorts plus an extended resource on the 10,000-node
   scenario with 10% of the pods each (the pod count cut to 10,000 to
   keep the plain loop short), kernel == plain including the port and
   scalar rows;
5. B6 at 10,000 nodes x 20,000 pods: three scenarios (all nodes; the
   last 10% off; every 7th off with 10% of the pods inactive) in one
   batch launch, equal to the batch plain version and to one
   `fused_scan_base` launch per scenario;
6. the slice's path at full width: a 10,000-node x 100,000-pod capacity
   plan written as a simon config and run through the port's CLI
   (`apply -f cfg --format json`) with the counters at 0. It must
   succeed, launch the single and the batch kernel, be minimal, and
   answer the JAX package's new-node count. Every scan the plan ran
   (placements and final rows) must equal the plain version on its
   scenarios, a batch launch of those scenarios must too, and every
   probe pair must equal single-kernel launches; B6's entry in the
   `kernels` line (time by CUDA events, plain time, bound) is that
   batch launch.

The last lines are the card (nvidia-smi name and power limit), a JSON
`kernels` line, and `{"ok": true, "device": {...}}`. It imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_NODES = 10_000
N_PODS = 20_000
SEED = 0
GPU_NODES = 1_000
GPU_PODS = 10_000
MIXED_PODS = 10_000  # phase 4b, cut from 20,000 for the plain loop
CAP_NODES = 10_000
CAP_PODS = 100_000
# new nodes the JAX package plans for the phase-6 scenario: its
# probe_plan on the XLA scan (CPU) answers +55, as its TPU benchmark
# records did (BENCH_r02-r05.json)
JAX_CAPACITY_ANSWER = 55
# bytes/s of HBM and the non-tensor f32 rate of one H100 SXM (NVIDIA
# data sheet); the scan's int64/f64 work has no faster path than that
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# integer and f64 operations per (pod, node) visit: fit (~10),
# least (~10), balanced (~10), normalisation bounds (~5), pass 2 (~15);
# the B2 blocks add about 3 per scalar kind, 2 per port word and 4 per
# GPU device (a GPU-share class only)
OPS_PER_NODE_VISIT = 50
OPS_PER_SCALAR, OPS_PER_PORT_WORD, OPS_PER_GPU_DEVICE = 3, 2, 4


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def build_scenario(n_nodes=N_NODES, n_pods=N_PODS, seed=SEED, port_frac=0.0,
                   scalar_frac=0.0):
    """Node and pod dicts of the default scenario; `port_frac` /
    `scalar_frac` give that fraction of the pods a hostPort / an
    `example.com/accel` request (every node then offers 8 of it)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        cpu = int(rng.choice([16, 32, 64, 96]))
        name = f"node-{i:05d}"
        node = {
            "kind": "Node",
            "metadata": {
                "name": name,
                "labels": {"kubernetes.io/hostname": name, "zone": f"z{i % 16}"},
            },
            "status": {
                "allocatable": {"cpu": str(cpu), "memory": f"{cpu * 4}Gi", "pods": "110"}
            },
        }
        if i % 11 == 0:
            node["spec"] = {"taints": [
                {"key": "dedicated", "value": "infra", "effect": "NoSchedule"}
            ]}
        if scalar_frac:
            node["status"]["allocatable"]["example.com/accel"] = "8"
        nodes.append(node)
    classes = [
        ("small", "250m", "512Mi", None, False),
        ("medium", "1", "2Gi", None, False),
        ("large", "4", "8Gi", None, False),
        ("zonal", "500m", "1Gi", {"zone": "z3"}, False),
        ("tolerant", "2", "4Gi", None, True),
    ]
    pods = []
    for p in range(n_pods):
        name, cpu, mem, selector, tol = classes[p % len(classes)]
        spec = {
            "containers": [{
                "name": "c",
                "image": f"img-{name}",
                "resources": {"requests": {"cpu": cpu, "memory": mem}},
            }],
            "schedulerName": "default-scheduler",
        }
        if selector:
            spec["nodeSelector"] = selector
        if tol:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        if port_frac and p % max(int(1 / port_frac), 1) == 0:
            hp = 8000 + (p // 100) % 4
            spec["containers"][0]["ports"] = [
                {"containerPort": hp, "hostPort": hp, "protocol": "TCP"}
            ]
        if scalar_frac and p % max(int(1 / scalar_frac), 1) == 1:
            spec["containers"][0]["resources"]["requests"]["example.com/accel"] = "1"
        pods.append({
            "metadata": {"name": f"pod-{p:06d}", "namespace": "bench",
                         "labels": {"cls": name}, "annotations": {}},
            "spec": spec,
        })
    return nodes, pods


def build_gpushare_scenario(n_nodes=GPU_NODES, n_pods=GPU_PODS):
    """V100-style nodes (8 devices x 32 Gi) and a fragmentation mix of
    4/8/16/32 Gi single-GPU shares and 16 Gi two-GPU jobs."""
    gi = 1 << 30
    nodes = []
    for i in range(n_nodes):
        name = f"gpu-node-{i:04d}"
        nodes.append({
            "kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name},
                         "annotations": {}},
            # gpu-count/gpu-mem live in CAPACITY (the open-gpu-share codec)
            "status": {
                "allocatable": {"cpu": "64", "memory": "256Gi", "pods": "110"},
                "capacity": {"cpu": "64", "memory": "256Gi", "pods": "110",
                             "alibabacloud.com/gpu-count": "8",
                             "alibabacloud.com/gpu-mem": str(8 * 32 * gi)},
            },
        })
    shapes = [(4 * gi, 1), (8 * gi, 1), (16 * gi, 1), (32 * gi, 1), (16 * gi, 2)]
    pods = []
    for p in range(n_pods):
        mem, cnt = shapes[p % len(shapes)]
        pods.append({
            "metadata": {"name": f"gpu-pod-{p:05d}", "namespace": "bench", "labels": {},
                         "annotations": {"alibabacloud.com/gpu-mem": str(mem),
                                         "alibabacloud.com/gpu-count": str(cnt)}},
            "spec": {"containers": [{"name": "c", "image": "img-gpu",
                                     "resources": {"requests": {"cpu": "4",
                                                                "memory": "16Gi"}}}],
                     "schedulerName": "default-scheduler"},
        })
    return nodes, pods


def build_capacity_scenario():
    """10,000 base nodes of 16 cpu / 64 Gi (every 23rd tainted) short of
    five Deployments of 20,000 replicas each, and a 96 cpu / 384 Gi new
    node: the planner must find the minimal new-node count."""

    def node(name, cpu, mem_gi, labels=None, taints=None):
        out = {"kind": "Node", "metadata": {
            "name": name, "labels": {"kubernetes.io/hostname": name, **(labels or {})}},
            "status": {"allocatable": {"cpu": str(cpu), "memory": f"{mem_gi}Gi",
                                       "pods": "110"}}}
        if taints:
            out["spec"] = {"taints": taints}
        return out

    taint = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
    nodes = [node(f"node-{i:05d}", 16, 64, {"zone": f"z{i % 16}"},
                  taint if i % 23 == 0 else None) for i in range(CAP_NODES)]

    def deploy(name, replicas, cpu, mem, tolerant=False):
        spec = {"containers": [{"name": "c", "image": f"img-{name}",
                                "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
        if tolerant:
            spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        return {"kind": "Deployment",
                "metadata": {"name": name, "namespace": "bench", "labels": {"app": name}},
                "spec": {"replicas": replicas, "template": {"spec": spec}}}

    rep = CAP_PODS // 5
    deployments = [
        deploy("memheavy", rep, "750m", "8Gi"),
        deploy("large", rep, "4", "8Gi"),
        deploy("medium", rep, "1", "2Gi"),
        deploy("small", rep, "250m", "512Mi"),
        deploy("tolerant", rep, "2", "4Gi", tolerant=True),
    ]
    return nodes, deployments, node("template", 96, 384)


def write_capacity_config(root) -> str:
    """The phase-6 scenario as a simon config under `root`."""
    from pathlib import Path

    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes, deployments, new_node = build_capacity_scenario()
    for sub, docs in (("cluster", nodes), ("app", deployments), ("newnode", [new_node])):
        (root / sub).mkdir()
        with open(root / sub / "objects.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    cfg = root / "simon-config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "capacity"},
        "spec": {"cluster": {"customConfig": str(root / "cluster")},
                 "appList": [{"name": "bench", "path": str(root / "app")}],
                 "newNode": str(root / "newnode")},
    }))
    return str(cfg)


def encode(nodes, pods, device):
    """The fused-scan plan of `pods` (in simulate()'s queue order) on a
    fresh cluster, and the pod names in that order."""
    import copy

    from open_simulator_tpu_torch.ops import encode as enc
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.core import _sort_app_pods
    from open_simulator_tpu_torch.scheduler.oracle import Oracle

    oracle = Oracle(copy.deepcopy(nodes))
    ordered = _sort_app_pods(copy.deepcopy(pods))
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, ordered)
    dyn = enc.encode_dynamic(oracle, cluster)
    features = enc.features_of_batch(cluster, batch)
    plan = fused_scan.build_plan(cluster, batch, dyn, features, device=device)
    names = [p["metadata"]["name"] for p in ordered]
    return plan, batch, names


def bound(plan, class_of_pod, scenarios) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the scans must move
    (each input read once, each output written once) over HBM bandwidth
    and the operations this run's pods need over the core rate."""
    import numpy as np
    import torch

    n, p = plan.n, len(class_of_pod)
    plan_bytes = sum(t.numel() * t.element_size() for t in vars(plan).values()
                     if isinstance(t, torch.Tensor))
    k = plan.scal_alloc.shape[0] if plan.has_scal else 0
    g = plan.gpu_init.shape[0] if plan.has_gpu else 0
    w = plan.port_init.shape[0] if plan.has_ports else 0
    state_bytes = n * (6 * 8 + k * 8 + g * 8 + w * 4)
    per_scenario = p * (1 + 4) + n + p * 4 + state_bytes
    total_bytes = plan_bytes + p * 4 + len(scenarios) * per_scenario
    cls = np.asarray(class_of_pod)
    visit = np.full(plan.u, OPS_PER_NODE_VISIT + OPS_PER_SCALAR * k
                    + OPS_PER_PORT_WORD * w, dtype=np.int64)
    if plan.has_gpu:
        visit += OPS_PER_GPU_DEVICE * g * (plan.gpu_cls[:, 0].cpu().numpy() > 0)
    ops = 0
    for active, _valid, pinned in scenarios:
        scanned = np.asarray(active, bool)
        if pinned is not None:
            scanned &= np.asarray(pinned) < 0
        ops += int(visit[cls[scanned]].sum()) * n
    t_bytes = total_bytes / HBM_BYTES_PER_S
    t_ops = ops / CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def timed(fn, runs):
    import torch

    times = []
    out = None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def cuda_ms(fn):
    """fn()'s result and the card's milliseconds between two CUDA events
    around it (the wrapper's input copies and its launch)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(got, want) -> int:
    """Largest difference over placements and every final state row of
    one scan; raises when the rows differ in name."""
    (gp, gf), (wp, wf) = got, want
    if gf.keys() != wf.keys():
        raise AssertionError(f"final rows differ: {sorted(gf)} vs {sorted(wf)}")
    errs = [int((gp.long() - wp.long()).abs().max())]
    errs += [int((gf[f].long() - wf[f].long()).abs().max()) for f in gf]
    return max(errs)


def kernel_vs_plain(label, gpu, plan, batch, active, valid, runs=3) -> dict:
    """One kernel against its plain version on the same plan on the
    card: identical placements and rows, or the run fails."""
    from open_simulator_tpu_torch.ops import fused_scan

    args = (plan, batch.class_of_pod, active, valid)
    kw = {"pinned": batch.pinned_node}
    fused_scan.run_fused_scan(*args, **kw)  # warm
    got, k_times = timed(lambda: fused_scan.run_fused_scan(*args, **kw), runs)
    want, r_times = timed(lambda: fused_scan.fused_scan_reference(*args, **kw), 1)
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{label}: kernel != plain, max abs err {err}")
    b_ms, b_by = bound(plan, batch.class_of_pod, [(active, valid, batch.pinned_node)])
    res = {"ms": statistics.median(k_times), "times": k_times, "plain_ms": r_times[0],
           "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "placements": want[0].cpu().numpy(), "rows": sorted(want[1])}
    print(f"{label}: kernel == plain (placements and rows {res['rows']}); kernel "
          f"{res['ms']:.3f} ms (median of {runs}: {[round(t, 3) for t in k_times]}), "
          f"plain {res['plain_ms']:.1f} ms, bound {b_ms:.4f} ms by {b_by} [{gpu}]",
          flush=True)
    return res


def simulate_path(label, gpu, nodes, pods, names, plain_place, kernel) -> int:
    """Drive simulate(engine="cuda") with the counters at 0; require
    that `kernel` ran and every pod landed where the plain version put
    it. Returns the kernel's launch count."""
    import torch

    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.core import AppResource, simulate
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    cluster = ResourceTypes()
    cluster.nodes = nodes
    app = ResourceTypes()
    app.pods = pods
    reset_name_counter()
    GLOBAL.reset()
    fused_scan.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, [AppResource("bench", app)], engine="cuda")
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches = dict(fused_scan.LAUNCHES)
    note = GLOBAL.notes.get("batch-kernel")
    scan_s = GLOBAL.phase_seconds("engine/scan")
    placed = {p["metadata"]["name"]: ns.node["metadata"]["name"]
              for ns in result.node_status for p in ns.pods}
    node_names = [n["metadata"]["name"] for n in nodes]
    expect = {nm: node_names[i] for nm, i in zip(names, plain_place) if i >= 0}
    if launches[kernel] < 1:
        raise AssertionError(f"{label}: simulate() did not launch {kernel}: {launches}")
    if note != f"cuda-{kernel}":
        raise AssertionError(f"{label}: batch-kernel note {note!r}")
    if placed != expect:
        raise AssertionError(f"{label}: simulate() placements differ from the plain version")
    print(f"{label}: simulate(engine='cuda') placed {len(placed)}/{len(pods)} as the plain "
          f"version did ({len(result.unscheduled_pods)} unscheduled); launches {launches}; "
          f"note {note!r}; {sim_s:.3f} s end to end = {len(pods) / sim_s:.1f} pods/s; "
          f"engine/scan {scan_s * 1e3:.1f} ms ({100 * scan_s / sim_s:.1f}%) [{gpu}]",
          flush=True)
    phases = ", ".join(f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms"
                       for ph in GLOBAL.as_dict()["phases"])
    print(f"{label}: host clock by phase: {phases} [{gpu}]", flush=True)
    return launches[kernel]


def print_build(lib):
    """Registers and spills of each instantiation from nvcc's report:
    flags (batch, scalars, gpu, ports) of fused_scan_kernel<...>."""
    import re

    flags = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"fused_scan_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
        if m:
            flags = "".join(m.groups())
        elif flags and ("registers" in line or "spill" in line):
            print(f"  ptxas <batch,scal,gpu,ports>={flags}: {line.strip()}")


def phase6(gpu) -> dict:
    """The capacity plan through the port's CLI at full width."""
    import contextlib
    import io
    import tempfile

    import torch

    from open_simulator_tpu_torch import cli
    from open_simulator_tpu_torch.apply.applier import _capacity_feasible
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.parallel import sweep as sweep_mod
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    # the sweep, and every scan the plan runs: (plan, kind, scenarios,
    # outputs, start and end events on the card)
    sweeps, calls = [], []
    real_find = sweep_mod.CapacitySweep.find_min_count
    real_single, real_batch = fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch

    def find(self, *a, **k):
        sweeps.append(self)
        return real_find(self, *a, **k)

    def recorded(kind, plan, cls, scenarios, run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = run()
        end.record()
        calls.append((plan, kind, list(scenarios), outs, start, end))
        return outs

    def single(plan, cls, active, valid, pinned=None):
        return recorded("single", plan, cls, [(active, valid, pinned)],
                        lambda: [real_single(plan, cls, active, valid, pinned)])[0]

    def batch(plan, cls, scenarios):
        return recorded("batch", plan, cls, scenarios,
                        lambda: real_batch(plan, cls, scenarios))

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg = write_capacity_config(root)
        print(f"phase 6: wrote {CAP_NODES} nodes x {CAP_PODS} pods as a simon config in "
              f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
        sweep_mod.CapacitySweep.find_min_count = find
        fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch = single, batch
        out, err = io.StringIO(), io.StringIO()
        try:
            reset_name_counter()
            fused_scan.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(["apply", "-f", cfg, "--format", "json", "--trace"])
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            launches = dict(fused_scan.LAUNCHES)
        finally:
            sweep_mod.CapacitySweep.find_min_count = real_find
            fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch = real_single, real_batch
    trace = GLOBAL.as_dict()
    if rc != 0:
        raise AssertionError(f"phase 6: apply exited {rc}: {err.getvalue()[-2000:]}")
    doc = json.loads(out.getvalue())
    count = doc["newNodeCount"]
    placed = sum(len(n["pods"]) for n in doc["nodes"])
    if not doc["success"] or doc["unscheduledPods"] or placed != CAP_PODS:
        raise AssertionError(f"phase 6: success {doc['success']}, placed {placed}, "
                             f"{len(doc['unscheduledPods'])} unscheduled")
    if count != JAX_CAPACITY_ANSWER:
        raise AssertionError(f"phase 6: +{count} nodes, the JAX package plans "
                             f"+{JAX_CAPACITY_ANSWER}")
    if launches[fused_scan.KERNEL_NAME] < 1 or launches[fused_scan.BATCH_KERNEL_NAME] < 1:
        raise AssertionError(f"phase 6: the plan did not launch both kernels: {launches}")
    sweep = sweeps[0]
    plan, cls = sweep.plan, sweep.batch.class_of_pod
    if any(c[0] is not plan for c in calls):
        raise AssertionError("phase 6: a scan ran on another plan than the sweep's")
    kinds = [c[1] for c in calls]
    if (kinds.count("single") != launches[fused_scan.KERNEL_NAME]
            + launches[fused_scan.EXT_KERNEL_NAME]
            or kinds.count("batch") != launches[fused_scan.BATCH_KERNEL_NAME]):
        raise AssertionError(f"phase 6: recorded scans {kinds} != launches {launches}")

    def counts(scenarios):
        return [int(valid.sum()) - sweep.n_base for _a, valid, _p in scenarios]

    main_ms = [(kind, counts(scen), start.elapsed_time(end))
               for _, kind, scen, _, start, end in calls]
    phases = {ph["name"]: ph for ph in trace["phases"]}
    print(f"phase 6: apply planned +{count} nodes (the JAX package's answer) for "
          f"{placed} pods on {len(doc['nodes'])} nodes in {plan_s:.3f} s; launches "
          f"{launches}; card time of each scan (kind, counts, ms by CUDA events) "
          f"{main_ms} [{gpu}]", flush=True)
    print("phase 6: host clock by phase: " + ", ".join(
        f"{n} {ph['seconds'] * 1e3:.1f} ms x{ph['count']}" for n, ph in phases.items())
        + f" [{gpu}]", flush=True)

    # checks outside the main path (the counters are read): every scan
    # of the plan against the plain version in one call; B6 on the same
    # scenarios in one launch; single launches of each batch scenario;
    # and one node fewer than the answer
    scenarios = [sc for c in calls for sc in c[2]]
    outs = [(c[1], o) for c in calls for o in c[3]]
    want, r_times = timed(
        lambda: fused_scan.fused_scan_batch_reference(plan, cls, scenarios), 1)
    errs = {"single": 0, "batch": 0}
    for (kind, o), w in zip(outs, want):
        errs[kind] = max(errs[kind], max_abs_err(o, w))
    got, batch_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, scenarios))
    errs["batch"] = max([errs["batch"]] + [max_abs_err(g, w) for g, w in zip(got, want)])
    if errs["single"] or errs["batch"]:
        raise AssertionError(f"phase 6: scans of the plan != plain version: {errs}")
    single_ms = []
    for _, kind, scen, c_outs, _, _ in calls:
        if kind != "batch":
            continue
        for sc, o in zip(scen, c_outs):
            s, ms = cuda_ms(lambda: fused_scan.run_fused_scan(plan, cls, *sc))
            single_ms.append(ms)
            if max_abs_err(s, o):
                raise AssertionError(f"phase 6: probe_pair != single launch at "
                                     f"count {counts([sc])[0]}")
    pair = next(c[2] for c in calls if c[1] == "batch")
    _, pair_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, pair))
    feasible, caps = _capacity_feasible()
    lower = sweep.lower_bound(*caps)
    if count > lower and feasible(sweep.probe(count - 1)):
        raise AssertionError(f"phase 6: +{count - 1} nodes already satisfy the caps")
    b_ms, b_by = bound(plan, cls, scenarios)
    print(f"phase 6: every scan of the plan (counts {counts(scenarios)}) == plain "
          f"version ({r_times[0]:.1f} ms for all in one call); one batch launch of "
          f"them {batch_ms:.1f} ms == plain, bound {b_ms:.4f} ms by {b_by}; every probe "
          f"pair == single launches; +{count - 1} fails (lower bound {lower}); one "
          f"probe {statistics.median(single_ms):.1f} ms, one pair launch {pair_ms:.1f} ms "
          f"(CUDA events, {CAP_PODS} pods x {sweep.n} nodes) [{gpu}]", flush=True)
    batch_res = {"ms": batch_ms, "plain_ms": r_times[0], "max_abs_err": errs["batch"],
                 "bound_ms": b_ms, "bound_by": b_by}
    return {"launches": launches, "batch": batch_res, "single_err": errs["single"]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from open_simulator_tpu_torch.ops import fused_scan

    gpu = card()
    print(f"card: {gpu}", flush=True)

    # ---- phase 1: build
    t0 = time.perf_counter()
    lib = fused_scan.build_library()
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.2f} s [{gpu}]",
          flush=True)
    print_build(lib)

    # ---- phase 2: B1 kernel vs plain on the card
    t0 = time.perf_counter()
    nodes, pods = build_scenario()
    plan, batch, names = encode(nodes, pods, "cuda")
    print(f"phase 2: encoded {plan.n} nodes x {len(names)} pods, {plan.u} classes "
          f"in {time.perf_counter() - t0:.2f} s (host)", flush=True)
    if plan.ext:
        raise AssertionError("phase 2: the default scenario must be the base plan")
    p, n = len(names), plan.n
    base = kernel_vs_plain("phase 2", gpu, plan, batch, np.ones(p, bool), np.ones(n, bool))

    # ---- phase 3: the base main path
    base_launches = simulate_path("phase 3", gpu, nodes, pods, names, base["placements"],
                                  fused_scan.KERNEL_NAME)

    # ---- phase 4: B2
    g_nodes, g_pods = build_gpushare_scenario()
    g_plan, g_batch, g_names = encode(g_nodes, g_pods, "cuda")
    if not g_plan.has_gpu:
        raise AssertionError("phase 4a: the GPU-share plan has no GPU block")
    ext = kernel_vs_plain(f"phase 4a ({g_plan.n} GPU nodes x {len(g_names)} pods)", gpu,
                          g_plan, g_batch, np.ones(len(g_names), bool),
                          np.ones(g_plan.n, bool))
    ext_launches = simulate_path("phase 4a", gpu, g_nodes, g_pods, g_names,
                                 ext["placements"], fused_scan.EXT_KERNEL_NAME)
    m_nodes, m_pods = build_scenario(n_pods=MIXED_PODS, port_frac=0.1, scalar_frac=0.1)
    m_plan, m_batch, m_names = encode(m_nodes, m_pods, "cuda")
    if not (m_plan.has_ports and m_plan.has_scal):
        raise AssertionError("phase 4b: the plan lacks the port or scalar block")
    kernel_vs_plain(f"phase 4b (hostPorts + scalars, {m_plan.n} nodes x {len(m_names)} pods)",
                    gpu, m_plan, m_batch, np.ones(len(m_names), bool),
                    np.ones(m_plan.n, bool), runs=1)

    # ---- phase 5: B6, three scenarios of the default plan in one launch
    rng = np.random.RandomState(5)
    last_off = np.ones(n, bool)
    last_off[int(n * 0.9):] = False
    pin = batch.pinned_node
    scenarios = [
        (np.ones(p, bool), np.ones(n, bool), pin),
        (np.ones(p, bool), last_off, pin),
        (rng.rand(p) < 0.9, np.arange(n) % 7 != 0, pin),
    ]
    cls = batch.class_of_pod
    fused_scan.run_fused_scan_batch(plan, cls, scenarios)  # warm
    got, b_times = timed(lambda: fused_scan.run_fused_scan_batch(plan, cls, scenarios), 3)
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(plan, cls, scenarios), 1)
    singles, s_times = timed(lambda: [fused_scan.run_fused_scan(plan, cls, a, v, pinned=q)
                                      for a, v, q in scenarios], 1)
    batch_err = max(max_abs_err(g, w) for g, w in zip(got, want))
    single_err = max(max_abs_err(g, s) for g, s in zip(got, singles))
    if batch_err or single_err:
        raise AssertionError(f"phase 5: batch kernel != plain ({batch_err}) or != single "
                             f"launches ({single_err})")
    b_bound = bound(plan, cls, scenarios)
    print(f"phase 5: {len(scenarios)} scenarios in one batch launch == batch plain == "
          f"single launches; batch kernel {statistics.median(b_times):.3f} ms (median of "
          f"3: {[round(t, 3) for t in b_times]}), {len(scenarios)} single launches "
          f"{s_times[0]:.1f} ms, batch plain {r_times[0]:.1f} ms, bound "
          f"{b_bound[0]:.4f} ms by {b_bound[1]} [{gpu}]", flush=True)

    # ---- phase 6: the capacity plan through the CLI; B6's entry is
    # measured there, at the shapes of its main path
    del plan, g_plan, m_plan, got, want, singles
    torch.cuda.empty_cache()
    cap = phase6(gpu)
    base["max_abs_err"] = max(base["max_abs_err"], cap["single_err"])

    def entry(name, replaces, launches, res):
        return {"name": name, "route": "cuda",
                "source": "open_simulator_tpu_torch/csrc/fused_scan.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None}

    print(gpu)  # nvidia-smi's own line: name, power limit
    print(json.dumps({"kernels": [
        entry(fused_scan.KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:1690",
              base_launches, base),
        entry(fused_scan.EXT_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:1961",
              ext_launches, ext),
        entry(fused_scan.BATCH_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:2974",
              cap["launches"][fused_scan.BATCH_KERNEL_NAME], cap["batch"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
