#!/usr/bin/env python3
"""Smoke test of the GPU port (open_simulator_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no `ok` line):

1. build the CUDA kernels from the checkout's two sources (one nvcc for
   each, sm_90a, started together) and print each instantiation's
   registers and spills; each of the 22 instantiations' static shared
   memory must be at most what the wrapper counts beside a resident
   slice;
2. B1 on the default scenario (10,000 nodes x 20,000 pods in 5 classes,
   seed 0 — every 11th node tainted, one class with a nodeSelector, one
   with tolerations): the kernel and its plain PyTorch version on the
   same plan on the card, identical placements and final int64 state;
   time both; then the kernel on clusters of 1, 8 and 16 blocks (the
   private launcher) beside the rule's choice, each == plain, in us a
   pod step;
3. the base main path, `simulate(cluster, apps, engine="cuda")`, on that
   scenario with the launch counters at 0: the kernel ran, the trace
   names it and its cluster size, and all 20,000 pods were placed where
   phase 2's plain version placed them;
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
   batch launch, which then runs again on one block a scenario;
7. B3 (`fused_scan_store`) on bench.py's storage scenario (10,000 nodes
   with 2 VGs, an SSD and an HDD; 20,000 pods with 1-3 LVM volumes or
   an exclusive device): kernel == plain, placements and every row
   (VG usage and device bits included), then `simulate(engine="cuda")`
   on it; then the 6-VG shape (past the TPU plan's 4-VG cap), kernel ==
   plain. Phases 7-10 also run their instantiation at the rule's
   cluster size and on one block a scenario (the private launcher),
   each == plain, in us a scanned pod step;
8. B4 (`fused_scan_terms`) on the affinity stress (10,000 nodes in 16
   zones, 100 StatefulSets x 100 replicas with hostname anti-affinity,
   hard zone spread, soft hostname spread and preferred zone affinity):
   kernel == plain including every value-space term row, then
   `simulate(engine="cuda")`;
9. B5: the same block on the same stress at 25,000 nodes (where the
   JAX package streams its term state), kernel == plain, then
   `simulate(engine="cuda")`;
10. every block in one plan (bench.py's conformance mix: terms, ports,
    scalars, pins, storage, more than 128 classes, a zone soft spread
    and a required affinity group) as one launch and as a batch of
    three node masks, both == the plain version;
11. the slice's path: `apply -f example/simon-config.yaml --format
    json` through the port's CLI on the card, byte-identical to its
    `--device cpu` run and planning the JAX package's +1 with the
    storage-and-terms kernel; then a full-width plan (10,000 storage
    nodes in 16 zones, the `hello` chart, the stress at 50 replicas, an
    LVM StatefulSet and a Deployment that fits only new nodes) that
    must plan the JAX package's count. Every scan either plan ran (its
    single probes and its pairs) == the batch plain version;
12. B7, the streaming-bandwidth probe: its entry point `run()` at the
    TPU tool's four sizes (8, 16, 32 and 64 MiB of int32 state) with
    the launch counter at 0, the kernel == its plain version exactly at
    each size, the 64 MiB size timed beside the plain version, its
    bound and one `torch.amax` over the same bytes; then a scan-step
    probe (the six int64 state rows of B1 at 10,000 nodes, 20,000
    steps) in microseconds a step;
13. A2, the eager torch scan: `simulate(engine="cuda",
    select_host="sample")` with a min-max custom score plugin on the
    default scenario's 10,000 nodes, with the counters at 0: it runs on
    the torch scan on CUDA tensors (the trace notes) and launches no
    fused kernel, equals the same call with `device="cpu"` (placements,
    node status, unscheduled reasons, the RNG's 607-word history) and
    the JAX package's digest (tools/jax_sample_answer.py).

Cuts that keep the script near 5 minutes (the kernels always run every
pod; the plain version runs the first pods of a scan, whose placements
do not depend on the later pods): phase 4b 5,000 pods; phase 5's plain
check the first 5,000 pods; phase 6's the first 30,000 of each of the
plan's scans; phase 7b 2,000 pods; phase 9's the first 4,000 pods;
phase 13's pods 2,000 of the default scenario's 20,000 (the torch scan
is an eager loop of some hundred launches a pod step).

The last lines are the card (nvidia-smi name and power limit), a JSON
`kernels` line (every fused-scan entry but the B2 one carries
`cluster`, the cluster size its main path ran, and `prev_ms`, the same
work on one block a scenario, timed in this run; the
`fused_scan_store_terms` entry is phase 10's single launch with the
launches of phase 11's full-width plan), and
`{"ok": true, "device": {...}}`. It imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 10_000
N_PODS = 20_000
SEED = 0
GPU_NODES = 1_000
GPU_PODS = 10_000
MIXED_PODS = 5_000  # phase 4b, cut from 20,000 for the plain loop
# the plain version's pods in phases 5 and 6: the first this many of
# each scan (the kernel runs every pod; a scan's first pods do not
# depend on the later ones), to keep the script near 5 minutes
PHASE5_PLAIN_PODS = 5_000
CAP_PLAIN_PODS = 30_000
CAP_NODES = 10_000
CAP_PODS = 100_000
# new nodes the JAX package plans for the phase-6 scenario: its
# probe_plan on the XLA scan (CPU) answers +55, as its TPU benchmark
# records did (BENCH_r02-r05.json)
JAX_CAPACITY_ANSWER = 55
# phase 7: bench.py's storage scenario; the 6-VG storage-fallback shape
# with its pods cut from 20,000 for the plain loop
STOR_NODES = 10_000
STOR_PODS = 20_000
FALLBACK_VGS = 6
FALLBACK_PODS = 2_000
# phases 8 and 9: the affinity stress (100 StatefulSets x 100 replicas,
# 16 zones) at 10,000 nodes and at 25,000, where the JAX package streams
# its term state
AFF_NODES = 10_000
AFF_STS = 100
AFF_REPLICAS = 100
AFF_ZONES = 16
B5_NODES = 25_000
B5_PLAIN_PODS = 4_000  # phase 9's kernel-vs-plain, cut from 10,000
# phase 10: bench.py's conformance mix
FUZZ_NODES = 1_000
FUZZ_PODS = 2_000
# phase 11: the repo's quickstart, whose plan the JAX package's CLI
# answers with one new node, and the full-width plan
# (write_plan_config), for which tools/jax_plan_answer.py (the JAX
# package's CLI on its XLA scan, on a CPU) answers +50 for 6,102 pods
QUICKSTART = "example/simon-config.yaml"
JAX_QUICKSTART_ANSWER = 1
PLAN_NODES = 10_000
PLAN_REPLICAS = 50
PLAN_KV_REPLICAS = 1_000
PLAN_HEAVY_REPLICAS = 100
JAX_PLAN_ANSWER = 50
# phase 12: B7, the streaming probe at the TPU tool's four sizes, and a
# scan-step probe: the six int64 state rows of B1 at 10,000 nodes
# (480,000 bytes, 936 rows of 128 int32 lanes at block_rows 8) for
# 20,000 steps, beside B1's 38 us a pod step on one block
PROBE_BYTES = 6 * 8 * N_NODES
PROBE_BLOCK_ROWS = 8
PROBE_STEPS = 20_000
# phase 13: A2, the eager torch scan, on the default scenario's 10,000
# nodes with its pods cut from 20,000, a custom min-max score plugin and
# select_host="sample" on a GoRand(A2_SEED) stream; JAX_SAMPLE_ANSWER is
# the digest (a2_digest) of the JAX package's simulate(engine="tpu") on
# the same inputs, from tools/jax_sample_answer.py (its XLA scan on a
# CPU)
A2_PODS = 2_000
A2_SEED = 7
A2_APP = "a2"
JAX_SAMPLE_ANSWER = "4812b742297bc9d0f0a42fb91eddcc08d8f41de149ce0bacd2d1cd2403f14a9f"
# phase 2: the cluster sizes B1 runs at beside the rule's choice
PHASE2_CLUSTERS = (1, 8, 16)
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
# the storage block, for a class with volumes: about 6 per (LVM volume,
# VG) of the binpack, 8 per VG of the score and 4 per device of the
# first-fit walk; the term block: about 14 per relevant term row (a
# topology value, four counts, the filters and the raw score), 5 per
# affinity-group row, 12 per hard-spread constraint (its minimum and
# its filter) and 12 per soft-spread constraint (stamp, count, score)
OPS_PER_VG_VOLUME, OPS_PER_VG, OPS_PER_DEVICE = 6, 8, 4
OPS_PER_TERM_ROW, OPS_PER_GROUP_ROW, OPS_PER_HARD_SLOT, OPS_PER_SOFT_SLOT = 14, 5, 12, 12


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


GI = 1 << 30


def storage_anno(n_vgs):
    """The open-local annotation of bench.py's storage nodes: `n_vgs`
    VGs of 100 / 200 GiB, a 120 GiB SSD and a 500 GiB HDD."""
    return json.dumps({
        "vgs": [{"name": f"pool-{chr(ord('a') + v)}",
                 "capacity": str((100 + 100 * (v % 2)) * GI), "requested": "0"}
                for v in range(n_vgs)],
        "devices": [{"name": "/dev/vdb", "capacity": str(120 * GI), "mediaType": "ssd",
                     "isAllocated": "false"},
                    {"name": "/dev/vdc", "capacity": str(500 * GI), "mediaType": "hdd",
                     "isAllocated": "false"}],
    })


def build_storage_scenario(n_nodes=STOR_NODES, n_pods=STOR_PODS, n_vgs=2):
    """bench.py's storage scenario: 32 cpu / 128 GiB nodes with the
    storage of storage_anno; 90% of the pods bin-pack 1-3 LVM volumes,
    10% claim an exclusive SSD or HDD."""
    anno = storage_anno(n_vgs)
    nodes = [{"kind": "Node", "metadata": {
        "name": f"stor-node-{i:05d}", "labels": {"kubernetes.io/hostname": f"stor-node-{i:05d}"},
        "annotations": {"simon/node-local-storage": anno}},
        "status": {"allocatable": {"cpu": "32", "memory": "128Gi", "pods": "110"},
                   "capacity": {"cpu": "32", "memory": "128Gi", "pods": "110"}}}
        for i in range(n_nodes)]
    lvm = [[("LVM", 1)], [("LVM", 5)], [("LVM", 10), ("LVM", 2)],
           [("LVM", 8), ("LVM", 4), ("LVM", 1)]]
    dev = [[("SSD", 100)], [("HDD", 400)]]
    pods = []
    for p in range(n_pods):
        vols = dev[(p // 10) % 2] if p % 10 == 9 else lvm[p % 4]
        payload = {"volumes": [{"kind": k, "size": str(s * GI),
                                "scName": f"open-local-{k.lower()}"} for k, s in vols]}
        pods.append({
            "metadata": {"name": f"stor-pod-{p:06d}", "namespace": "bench", "labels": {},
                         "annotations": {"simon/pod-local-storage": json.dumps(payload)}},
            "spec": {"containers": [{"name": "c", "image": "kv", "resources": {
                "requests": {"cpu": "250m", "memory": "512Mi"}}}],
                "schedulerName": "default-scheduler"},
        })
    return nodes, pods


def affinity_nodes(n_nodes, zones, anno=None):
    """32 cpu / 64 GiB nodes in `zones` zones (the affinity stress's),
    with an open-local annotation when `anno` is given."""
    nodes = []
    for i in range(n_nodes):
        name = f"sn-{i:05d}"
        node = {"kind": "Node", "apiVersion": "v1", "metadata": {
            "name": name, "labels": {"kubernetes.io/hostname": name, "zone": f"z{i % zones}"},
            "annotations": {}},
            "status": {"allocatable": {"cpu": "32", "memory": "64Gi", "pods": "110"},
                       "capacity": {"cpu": "32", "memory": "64Gi", "pods": "110"}}}
        if anno is not None:
            node["metadata"]["annotations"]["simon/node-local-storage"] = anno
        nodes.append(node)
    return nodes


def affinity_stateful_sets(n_sts=AFF_STS, replicas=AFF_REPLICAS, namespace="stress"):
    """The affinity stress of the JAX package's testing.py: every
    StatefulSet has required hostname anti-affinity on its own app
    label and a hard zone spread (maxSkew 1); odd ones a soft hostname
    spread (maxSkew 2); every third one a preferred zone affinity
    (weight 50) to the previous StatefulSet's pods."""
    stss = []
    for s in range(n_sts):
        app = f"sts-{s:03d}"
        selector = {"matchLabels": {"app": app}}
        affinity = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": selector, "topologyKey": "kubernetes.io/hostname"}]}}
        if s % 3 == 2:
            affinity["podAffinity"] = {"preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 50, "podAffinityTerm": {
                    "labelSelector": {"matchLabels": {"app": f"sts-{s - 1:03d}"}},
                    "topologyKey": "zone"}}]}
        spread = [{"maxSkew": 1, "topologyKey": "zone", "whenUnsatisfiable": "DoNotSchedule",
                   "labelSelector": selector}]
        if s % 2 == 1:
            spread.append({"maxSkew": 2, "topologyKey": "kubernetes.io/hostname",
                           "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": selector})
        stss.append({
            "kind": "StatefulSet", "apiVersion": "apps/v1",
            "metadata": {"name": app, "namespace": namespace, "labels": {"app": app}},
            "spec": {"selector": {"matchLabels": {"app": app}}, "replicas": replicas,
                     "template": {"metadata": {"labels": {"app": app}}, "spec": {
                         "containers": [{"name": "c", "image": f"image-{app}", "resources": {
                             "requests": {"cpu": "500m", "memory": "1Gi"}}}],
                         "affinity": affinity, "topologySpreadConstraints": spread}}},
        })
    return stss


def expand(nodes, workloads, app="stress"):
    """Pods of StatefulSets in simulate()'s queue order (the port's
    workload expansion)."""
    from open_simulator_tpu_torch.models import workloads as wl
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import _sort_app_pods

    wl.reset_name_counter()
    res = ResourceTypes()
    res.stateful_sets = workloads
    return _sort_app_pods(wl.generate_valid_pods_from_app(app, res, nodes))


def build_fuzz_scenario(n_nodes=FUZZ_NODES, n_pods=FUZZ_PODS, seed=0):
    """bench.py run_conformance_fuzz's mix: the affinity stress over 20
    StatefulSets in 8 zones with hostPorts, an extended resource, pins
    and open-local volumes stamped on a tenth of the pods (each a class
    of its own: more than 128 classes), plus a zone-keyed ScheduleAnyway
    spread and a required zone affinity on some StatefulSets, so that the
    non-hostname soft path and the affinity-group path run."""
    import copy

    import numpy as np

    rng = np.random.RandomState(seed)
    nodes = affinity_nodes(n_nodes, 8)
    stss = affinity_stateful_sets(20, max(n_pods // 20, 1), "fuzz")
    for s, sts in enumerate(stss):
        spec = sts["spec"]["template"]["spec"]
        if s % 4 == 0:
            spec["topologySpreadConstraints"].append({
                "maxSkew": 2, "topologyKey": "zone", "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": sts["metadata"]["name"]}}})
        if s % 5 == 4:
            spec["affinity"]["podAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "sts-000"}}, "topologyKey": "zone"}]}
    pods = expand(nodes, stss, "fuzz")
    for node in nodes[: n_nodes // 2]:
        node["status"]["allocatable"]["example.com/accel"] = "4"
    anno = json.dumps({"vgs": [{"name": "a", "capacity": str(100 * GI), "requested": "0"}],
                       "devices": [{"name": "/dev/vdb", "capacity": str(120 * GI),
                                    "mediaType": "ssd", "isAllocated": "false"}]})
    for node in nodes[: n_nodes // 3]:
        node["metadata"]["annotations"]["simon/node-local-storage"] = anno
    for i, pod in enumerate(pods[:n_pods]):
        k = rng.randint(0, 40)
        if k > 3:
            continue
        pod["spec"] = spec = copy.deepcopy(pod["spec"])
        if k == 0:
            port = 9000 + int(rng.randint(0, 3))
            spec["containers"][0]["ports"] = [
                {"containerPort": port, "hostPort": port, "protocol": "TCP"}]
        elif k == 1:
            spec["containers"][0]["resources"]["requests"]["example.com/accel"] = str(1 + i % 4)
        elif k == 2:
            spec["nodeName"] = nodes[int(rng.randint(0, n_nodes))]["metadata"]["name"]
        else:
            vols = ([{"kind": "LVM", "size": str((1 + i % 8) * GI), "scName": "open-local-lvm"}]
                    if i % 3 else
                    [{"kind": "SSD", "size": str(60 * GI), "scName": "open-local-device-ssd"}])
            pod["metadata"] = meta = dict(pod["metadata"])
            meta["annotations"] = dict(meta.get("annotations") or {})
            meta["annotations"]["simon/pod-local-storage"] = json.dumps({"volumes": vols})
    return nodes, pods[:n_pods]


def plan_workloads():
    """The apps of the full-width plan, after the `hello` chart: the
    affinity stress at PLAN_REPLICAS replicas, a StatefulSet of open-local
    LVM volumeClaimTemplates (example/application/storage/sts-local.yaml's
    shape) and a Deployment whose pods fit no existing node (40 cpu on 32
    cpu nodes), so that the planner must add nodes."""
    kv = {"apiVersion": "apps/v1", "kind": "StatefulSet",
          "metadata": {"name": "kv-store", "namespace": "default"},
          "spec": {"serviceName": "kv", "replicas": PLAN_KV_REPLICAS,
                   "selector": {"matchLabels": {"app": "kv-store"}},
                   "template": {"metadata": {"labels": {"app": "kv-store"}}, "spec": {
                       "containers": [{"name": "kv", "image": "kv:5.2", "resources": {
                           "requests": {"cpu": "500m", "memory": "1Gi"}}}]}},
                   "volumeClaimTemplates": [{"metadata": {"name": "data"}, "spec": {
                       "accessModes": ["ReadWriteOnce"], "storageClassName": "open-local-lvm",
                       "resources": {"requests": {"storage": "8Gi"}}}}]}}
    heavy = {"apiVersion": "apps/v1", "kind": "Deployment",
             "metadata": {"name": "batch-heavy", "namespace": "default",
                          "labels": {"app": "batch-heavy"}},
             "spec": {"replicas": PLAN_HEAVY_REPLICAS,
                      "selector": {"matchLabels": {"app": "batch-heavy"}},
                      "template": {"metadata": {"labels": {"app": "batch-heavy"}}, "spec": {
                          "containers": [{"name": "w", "image": "worker", "resources": {
                              "requests": {"cpu": "40", "memory": "64Gi"}}}]}}}}
    return [("stress", affinity_stateful_sets(AFF_STS, PLAN_REPLICAS)),
            ("local-storage", [kv]), ("batch-heavy", [heavy])]


def write_plan_config(root) -> str:
    """The full-width plan as a simon config under `root`: PLAN_NODES
    zone-labelled storage nodes (32 cpu / 128 GiB, phase 7's storage),
    the apps `hello` (the repo's example chart), the stress, the LVM
    StatefulSet and the heavy Deployment, in that order, and a 96 cpu /
    384 GiB new node."""
    from pathlib import Path

    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)
    nodes = affinity_nodes(PLAN_NODES, AFF_ZONES, storage_anno(2))
    for node in nodes:
        for key in ("allocatable", "capacity"):
            node["status"][key]["memory"] = "128Gi"
    new_node = {"kind": "Node", "apiVersion": "v1", "metadata": {
        "name": "template", "labels": {"kubernetes.io/hostname": "template"}},
        "status": {"allocatable": {"cpu": "96", "memory": "384Gi", "pods": "110"},
                   "capacity": {"cpu": "96", "memory": "384Gi", "pods": "110"}}}
    apps = [{"name": "hello-chart", "path": str(ROOT / "example/application/charts/hello"),
             "chart": True}]
    dirs = [("cluster", nodes), ("newnode", [new_node])]
    for name, objs in plan_workloads():
        dirs.append((f"app-{name}", objs))
        apps.append({"name": name, "path": str(root / f"app-{name}")})
    for sub, docs in dirs:
        (root / sub).mkdir()
        with open(root / sub / "objects.yaml", "w") as f:
            yaml.dump_all(docs, f, Dumper=dumper)
    cfg = root / "simon-config.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "plan"},
        "spec": {"cluster": {"customConfig": str(root / "cluster")}, "appList": apps,
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


def visit_ops(plan):
    """Integer and f64 operations of one (pod, node) visit, per class:
    the base count plus the blocks the class runs (the counts are a
    count of csrc/fused_scan.cu's source, not a measurement)."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    d = fused_scan.block_dims(plan)
    visit = np.full(plan.u, OPS_PER_NODE_VISIT + OPS_PER_SCALAR * d["k"]
                    + OPS_PER_PORT_WORD * d["w"], dtype=np.int64)
    if plan.has_gpu:
        visit += OPS_PER_GPU_DEVICE * d["g"] * (plan.gpu_cls[:, 0].cpu().numpy() > 0)
    if plan.has_store:
        lv = (plan.cls_lvm.cpu().numpy() > 0).sum(axis=1)
        wants = plan.cls_wants.cpu().numpy() > 0
        visit += wants * (OPS_PER_VG_VOLUME * lv * d["v"] + OPS_PER_VG * d["v"]
                          + OPS_PER_DEVICE * (d["ds"] + d["dh"]))
    if plan.has_terms:
        def slots(t):
            return (t.cpu().numpy() >= 0).sum(axis=1)

        visit += (OPS_PER_TERM_ROW * slots(plan.cls_rows)
                  + OPS_PER_GROUP_ROW * slots(plan.cls_grows)
                  + OPS_PER_HARD_SLOT * slots(plan.cls_hrows)
                  + OPS_PER_SOFT_SLOT * slots(plan.cls_srows))
    return visit


def bound(plan, class_of_pod, scenarios) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the scans must move
    (each input read once, each output written once) over HBM bandwidth
    and the operations this run's pods need over the core rate."""
    import numpy as np
    import torch

    from open_simulator_tpu_torch.ops import fused_scan

    n, p = plan.n, len(class_of_pod)
    d = fused_scan.block_dims(plan)
    plan_bytes = sum(t.numel() * t.element_size() for t in vars(plan).values()
                     if isinstance(t, torch.Tensor))
    state_bytes = n * (6 * 8 + d["k"] * 8 + d["g"] * 8 + d["w"] * 4
                       + d["v"] * 8 + d["ds"] + d["dh"])
    state_bytes += 8 * (4 * d["vt"] + d["va"] + d["a"] + d["vs"])
    per_scenario = p * (1 + 4) + n + p * 4 + state_bytes
    total_bytes = plan_bytes + p * 4 + len(scenarios) * per_scenario
    cls = np.asarray(class_of_pod)
    visit = visit_ops(plan)
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


def prefix(scenarios, k):
    """The scenarios with only their first `k` pods active."""
    import numpy as np

    return [(np.asarray(a, bool) & (np.arange(len(a)) < k), v, q) for a, v, q in scenarios]


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
    import numpy as np

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
    name = fused_scan.kernel_name(plan)
    res = {"ms": statistics.median(k_times), "times": k_times, "plain_ms": r_times[0],
           "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "placements": want[0].cpu().numpy(), "rows": sorted(want[1]), "want": want,
           "cluster": fused_scan.CLUSTERS[name]}
    steps = int((np.asarray(active, bool) & (np.asarray(batch.pinned_node) < 0)).sum())
    print(f"{label}: kernel == plain (placements and rows {res['rows']}); kernel "
          f"{res['ms']:.3f} ms (median of {runs}: {[round(t, 3) for t in k_times]}; cluster "
          f"{res['cluster']}: {res['ms'] * 1e3 / max(steps, 1):.3f} us a scanned pod step), "
          f"plain {res['plain_ms']:.1f} ms, bound {b_ms:.4f} ms by {b_by} [{gpu}]",
          flush=True)
    return res


def cluster_sweep(label, gpu, plan, batch, scenarios, want, clusters,
                  is_batch=False) -> dict:
    """The plan's kernel at each cluster size of `clusters` through the
    private launcher, on `scenarios` (one, or a batch): each run == the
    plain version's `want` (a list, one result a scenario); ms by CUDA
    events and us a scanned pod step of each, keyed by the cluster
    size."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    steps = sum(int((np.asarray(a, bool) & (np.asarray(q) < 0 if q is not None else True)).sum())
                for a, _v, q in scenarios)
    out = {}
    for c in clusters:
        def run():
            return fused_scan._run_with_cluster(plan, batch.class_of_pod, scenarios,
                                                is_batch, c)
        run()  # warm: the attribute calls of a new size
        got, ms = cuda_ms(run)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{label}: cluster {c}: kernel != plain ({err})")
        shape = fused_scan.launch_shape(plan, c)
        out[c] = ms
        rows = ("shared memory, cached" if shape.cached else
                "shared memory" if shape.resident else "global")
        if plan.has_terms:
            rows += ", replica in " + ("shared memory" if shape.replica else "global")
        print(f"{label}: {fused_scan.kernel_name(plan, is_batch)} at cluster {c} (slice "
              f"{-(-plan.n // c)} nodes, {rows} rows, {shape.smem} bytes): {ms:.3f} ms = "
              f"{ms * 1e3 / max(steps, 1):.3f} us a scanned pod step, == plain [{gpu}]",
              flush=True)
    return out


def simulate_path(label, gpu, nodes, pods, names, plain_place, kernel) -> int:
    """Drive simulate(engine="cuda") with the counters at 0; require
    that `kernel` ran and every pod landed where `plain_place` (a scan
    already held against the plain version) put it. Returns the
    kernel's launch count."""
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
    if note != f"cuda-{kernel} (cluster {fused_scan.CLUSTERS[kernel]})":
        raise AssertionError(f"{label}: batch-kernel note {note!r}")
    if placed != expect:
        raise AssertionError(f"{label}: simulate() placements differ from the checked scan's")
    print(f"{label}: simulate(engine='cuda') placed {len(placed)}/{len(pods)} as the checked "
          f"scan did ({len(result.unscheduled_pods)} unscheduled); launches {launches}; "
          f"note {note!r}; {sim_s:.3f} s end to end = {len(pods) / sim_s:.1f} pods/s; "
          f"engine/scan {scan_s * 1e3:.1f} ms ({100 * scan_s / sim_s:.1f}%) [{gpu}]",
          flush=True)
    phases = ", ".join(f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms"
                       for ph in GLOBAL.as_dict()["phases"])
    print(f"{label}: host clock by phase: {phases} [{gpu}]", flush=True)
    return launches[kernel]


def print_build(lib):
    """Registers and spills of each instantiation from nvcc's report:
    flags (batch, scalars, gpu, ports, storage, terms) of
    fused_scan_kernel<...>; then each instantiation's static shared
    memory as the card reports it, which must be at most the wrapper's
    figure (STATIC_SMEM for the 16 base and B2 ones, STATIC_SMEM_STORE
    and STATIC_SMEM_TERMS for the 6 storage and term ones)."""
    import ctypes
    import re

    from open_simulator_tpu_torch.ops import fused_scan

    flags = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"fused_scan_kernelI" + "Lb(\\d)E" * 6, line)
        if m:
            flags = "".join(m.groups())
        elif flags and ("registers" in line or "spill" in line):
            print(f"  ptxas <batch,scal,gpu,ports,store,terms>={flags}: {line.strip()}")
    big = [b | 7 | blk for b in (0, 8) for blk in (16, 32, 48)]
    sizes = {}
    for flags in list(range(16)) + big:
        want = (fused_scan.STATIC_SMEM_TERMS if flags & 32 else
                fused_scan.STATIC_SMEM_STORE if flags & 16 else fused_scan.STATIC_SMEM)
        out = ctypes.c_int64(-1)
        err = fused_scan._library().fused_scan_static_smem(flags, ctypes.byref(out))
        if err or not 0 < out.value <= want:
            raise AssertionError(f"phase 1: instantiation {flags}: static shared memory "
                                 f"{out.value} (cudaError {err}), the wrapper counts {want}")
        sizes.setdefault(want, []).append(out.value)
    print("phase 1: static shared memory of the 22 instantiations: " + "; ".join(
        f"{len(v)} at {min(v)}-{max(v)} bytes <= the wrapper's {k}"
        for k, v in sorted(sizes.items())))


def run_cli(argv, cwd=None):
    """The port's CLI in this process: (exit code, stdout, stderr), with
    the pod-name counter reset first."""
    import contextlib
    import io
    import os

    from open_simulator_tpu_torch import cli
    from open_simulator_tpu_torch.models.workloads import reset_name_counter

    out, err = io.StringIO(), io.StringIO()
    reset_name_counter()
    with contextlib.chdir(cwd or os.getcwd()), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def plan_on_card(argv, cwd=None) -> dict:
    """Run a plan through the port's CLI on the card with the launch
    counters at 0, recording the sweep and every scan it runs (plan,
    kind, scenarios, outputs, start and end CUDA events)."""
    import torch

    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.parallel import sweep as sweep_mod
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    sweeps, calls = [], []
    real_find = sweep_mod.CapacitySweep.find_min_count
    real_single, real_batch = fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch

    def find(self, *a, **k):
        sweeps.append(self)
        return real_find(self, *a, **k)

    def recorded(kind, plan, scenarios, run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = run()
        end.record()
        calls.append((plan, kind, list(scenarios), outs, start, end))
        return outs

    def single(plan, cls, active, valid, pinned=None):
        return recorded("single", plan, [(active, valid, pinned)],
                        lambda: [real_single(plan, cls, active, valid, pinned)])[0]

    def batch(plan, cls, scenarios):
        return recorded("batch", plan, scenarios, lambda: real_batch(plan, cls, scenarios))

    sweep_mod.CapacitySweep.find_min_count = find
    fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch = single, batch
    try:
        fused_scan.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = run_cli(argv, cwd)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        launches = dict(fused_scan.LAUNCHES)
    finally:
        sweep_mod.CapacitySweep.find_min_count = real_find
        fused_scan.run_fused_scan, fused_scan.run_fused_scan_batch = real_single, real_batch
    if rc != 0:
        raise AssertionError(f"{argv}: exited {rc}: {err[-2000:]}")
    sweep = sweeps[0]
    if any(c[0] is not sweep.plan for c in calls):
        raise AssertionError(f"{argv}: a scan ran on another plan than the sweep's")
    kinds = [c[1] for c in calls]
    singles = sum(v for k, v in launches.items() if k != fused_scan.BATCH_KERNEL_NAME)
    if (kinds.count("single") != singles
            or kinds.count("batch") != launches[fused_scan.BATCH_KERNEL_NAME]):
        raise AssertionError(f"{argv}: recorded scans {kinds} != launches {launches}")

    def counts(scenarios):
        return [int(valid.sum()) - sweep.n_base for _a, valid, _p in scenarios]

    return {"doc": json.loads(out), "out": out, "launches": launches, "calls": calls,
            "sweep": sweep, "trace": GLOBAL.as_dict(), "plan_s": plan_s, "counts": counts,
            "main_ms": [(kind, counts(scen), start.elapsed_time(end))
                        for _, kind, scen, _, start, end in calls]}


def hold_plan_scans(label, gpu, res) -> None:
    """Every scan a plan ran (its single probes and its pairs) against
    one call of the batch plain version on all their scenarios:
    placements and every final row."""
    from open_simulator_tpu_torch.ops import fused_scan

    sweep, calls = res["sweep"], res["calls"]
    scenarios = [sc for c in calls for sc in c[2]]
    outs = [o for c in calls for o in c[3]]
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(
        sweep.plan, sweep.batch.class_of_pod, scenarios), 1)
    err = max(max_abs_err(o, w) for o, w in zip(outs, want))
    if err:
        raise AssertionError(f"{label}: a scan of the plan != batch plain ({err})")
    print(f"{label}: every scan of the plan (kinds {[c[1] for c in calls]}, counts "
          f"{res['counts'](scenarios)}) == batch plain ({r_times[0]:.1f} ms for all in one "
          f"call), placements and every row [{gpu}]", flush=True)


def print_plan(label, gpu, res) -> None:
    doc = res["doc"]
    placed = sum(len(n["pods"]) for n in doc["nodes"])
    print(f"{label}: apply planned +{doc['newNodeCount']} nodes for {placed} pods on "
          f"{len(doc['nodes'])} nodes in {res['plan_s']:.3f} s; launches {res['launches']}; "
          f"card time of each scan (kind, counts, ms by CUDA events) {res['main_ms']} [{gpu}]",
          flush=True)
    print(f"{label}: host clock by phase: " + ", ".join(
        f"{ph['name']} {ph['seconds'] * 1e3:.1f} ms x{ph['count']}"
        for ph in res["trace"]["phases"]) + f" [{gpu}]", flush=True)


def phase6(gpu) -> dict:
    """The capacity plan through the port's CLI at full width."""
    import tempfile

    from open_simulator_tpu_torch.apply.applier import _capacity_feasible
    from open_simulator_tpu_torch.ops import fused_scan

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg = write_capacity_config(root)
        print(f"phase 6: wrote {CAP_NODES} nodes x {CAP_PODS} pods as a simon config in "
              f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
        res = plan_on_card(["apply", "-f", cfg, "--format", "json", "--trace"])
    doc, launches, calls = res["doc"], res["launches"], res["calls"]
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
    print_plan("phase 6 (the JAX package's answer)", gpu, res)
    sweep, counts = res["sweep"], res["counts"]
    plan, cls = sweep.plan, sweep.batch.class_of_pod

    # checks outside the main path (the counters are read): B6 on every
    # scan of the plan in one launch, equal to the plan's own scans;
    # the plan's scans over their first CAP_PLAIN_PODS pods against the
    # plain version in one call, kernel (one batch launch) and plain;
    # single launches of each batch scenario; and one node fewer than
    # the answer
    import numpy as np

    scenarios = [sc for c in calls for sc in c[2]]
    outs = [(c[1], o) for c in calls for o in c[3]]
    got, full_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, scenarios))
    if max(max_abs_err(g, o) for g, (_k, o) in zip(got, outs)):
        raise AssertionError("phase 6: a batch launch of the plan's scans != its own scans")
    cut = prefix(scenarios, CAP_PLAIN_PODS)
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(plan, cls, cut), 1)
    got, batch_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, cut))
    batch_cluster = fused_scan.CLUSTERS[fused_scan.BATCH_KERNEL_NAME]
    errs = {"single": 0, "batch": max(max_abs_err(g, w) for g, w in zip(got, want))}
    # the same launch on one block a scenario (the previous design's shape)
    fused_scan._run_with_cluster(plan, cls, prefix(cut[:1], 10), True, 1)  # warm
    one, one_ms = cuda_ms(lambda: fused_scan._run_with_cluster(plan, cls, cut, True, 1))
    errs["batch"] = max(errs["batch"], max(max_abs_err(g, w) for g, w in zip(one, want)))
    for (kind, o), w in zip(outs, want):
        head = np.asarray(o[0].cpu())[:CAP_PLAIN_PODS] != np.asarray(w[0].cpu())[:CAP_PLAIN_PODS]
        errs[kind] = max(errs[kind], int(head.sum()))
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
    b_ms, b_by = bound(plan, cls, cut)
    print(f"phase 6: one batch launch of every scan of the plan (counts "
          f"{counts(scenarios)}) {full_ms:.1f} ms == the plan's own scans; their first "
          f"{CAP_PLAIN_PODS} pods (placements of the plan's scans, and one batch launch "
          f"{batch_ms:.1f} ms, on one block a scenario {one_ms:.1f} ms, placements and every "
          f"row) == plain version "
          f"({r_times[0]:.1f} ms for all in one call), bound {b_ms:.4f} ms by {b_by}; every "
          f"probe pair == single launches; +{count - 1} fails (lower bound {lower}); one "
          f"probe {statistics.median(single_ms):.1f} ms, one pair launch {pair_ms:.1f} ms "
          f"(CUDA events, {CAP_PODS} pods x {sweep.n} nodes; clusters of {batch_cluster}) "
          f"[{gpu}]", flush=True)
    batch_res = {"ms": batch_ms, "plain_ms": r_times[0], "max_abs_err": errs["batch"],
                 "bound_ms": b_ms, "bound_by": b_by, "cluster": batch_cluster,
                 "prev_ms": one_ms}
    return {"launches": launches, "batch": batch_res, "single_err": errs["single"]}


def block_phase(label, gpu, nodes, pods, kernel, runs=1, simulate=True,
                plain_pods=None) -> dict:
    """One scenario of a new block: the kernel against its plain version
    on the card (placements and every final row; with `plain_pods`, over
    the first that many pods, and the kernel once more over all of
    them), then, with `simulate`, simulate(engine="cuda") on it with the
    counters at 0. Returns the comparison's numbers with the main
    path's launches."""
    import numpy as np
    import torch

    from open_simulator_tpu_torch.ops import fused_scan

    t0 = time.perf_counter()
    plan, batch, names = encode(nodes, pods, "cuda")
    if fused_scan.kernel_name(plan) != kernel:
        raise AssertionError(f"{label}: the plan runs {fused_scan.kernel_name(plan)}, "
                             f"not {kernel}")
    d = fused_scan.block_dims(plan)
    print(f"{label}: encoded {plan.n} nodes x {len(names)} pods, {plan.u} classes, block "
          f"sizes { {k: v for k, v in d.items() if v} } in {time.perf_counter() - t0:.2f} s "
          f"(host); scratch and block state {fused_scan.scratch_bytes(plan) / 2**20:.1f} MiB "
          f"a scenario", flush=True)
    p, valid = len(names), np.ones(plan.n, bool)
    active = np.arange(p) < (p if plain_pods is None else plain_pods)
    res = kernel_vs_plain(label, gpu, plan, batch, active, valid, runs=runs)
    # the rule's cluster size and one block a scenario, timed in turn
    sweep = cluster_sweep(label, gpu, plan, batch, [(active, valid, batch.pinned_node)],
                          [res.pop("want")], (res["cluster"], 1))
    res["cluster_ms"], res["prev_ms"] = sweep[res["cluster"]], sweep[1]
    placements = res["placements"]
    print(f"{label}: {int((placements >= 0).sum())}/{int(active.sum())} placed by both",
          flush=True)
    if plain_pods is not None:
        (full, _), ms = cuda_ms(lambda: fused_scan.run_fused_scan(
            plan, batch.class_of_pod, np.ones(p, bool), valid, pinned=batch.pinned_node))
        placements = full.cpu().numpy()
        if (placements[:plain_pods] != res["placements"][:plain_pods]).any():
            raise AssertionError(f"{label}: the full scan's first pods differ from the cut's")
        print(f"{label}: the kernel over all {p} pods {ms:.1f} ms (CUDA events), its first "
              f"{plain_pods} placements those of the cut; "
              f"{int((placements >= 0).sum())}/{p} placed [{gpu}]", flush=True)
    res["launches"] = 0
    if simulate:
        del plan
        torch.cuda.empty_cache()
        res["launches"] = simulate_path(label, gpu, nodes, pods, names, placements, kernel)
    return res


def phase10(gpu) -> dict:
    """Every block in one plan: bench.py's conformance mix as one launch
    and as a B6 batch of three node masks, both equal to the plain
    version, each at the rule's cluster size and on one block a
    scenario. Returns the single launch's numbers (fused_scan_store_terms
    at this shape) and the batch's."""
    import numpy as np

    from open_simulator_tpu_torch.ops import fused_scan

    nodes, pods = build_fuzz_scenario()
    plan, batch, names = encode(nodes, pods, "cuda")
    blocks = (plan.has_store, plan.has_terms, plan.has_scal, plan.has_ports, plan.has_pins)
    host_soft = plan.s_host.cpu().numpy()
    soft_rows = plan.cls_srows.cpu().numpy()
    zone_soft = bool(((soft_rows >= 0) & ~host_soft[np.maximum(soft_rows, 0)].astype(bool)).any())
    groups = bool((plan.cls_gid.cpu().numpy() >= 0).any())
    if not all(blocks) or plan.u <= 128 or not zone_soft or not groups:
        raise AssertionError(f"phase 10: blocks {blocks}, {plan.u} classes, zone soft "
                             f"spread {zone_soft}, affinity group {groups}")
    n, p = plan.n, len(names)
    pin = batch.pinned_node
    every5 = np.arange(n) % 5 != 0
    last_off = np.ones(n, bool)
    last_off[int(n * 0.9):] = False
    scen = [(np.ones(p, bool), np.ones(n, bool), pin), (np.ones(p, bool), every5, pin),
            (np.ones(p, bool), last_off, pin)]
    cls = batch.class_of_pod
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(plan, cls, scen), 1)
    one, o_times = timed(lambda: fused_scan.fused_scan_reference(plan, cls, *scen[0]), 1)
    fused_scan.run_fused_scan(plan, cls, *scen[0])  # warm
    single, s_ms = cuda_ms(lambda: fused_scan.run_fused_scan(plan, cls, *scen[0]))
    got, b_ms = cuda_ms(lambda: fused_scan.run_fused_scan_batch(plan, cls, scen))
    err = max([max_abs_err(single, one), max_abs_err(one, want[0])]
              + [max_abs_err(g, w) for g, w in zip(got, want)])
    if err:
        raise AssertionError(f"phase 10: kernel != batch plain, max abs err {err}")
    c_single = fused_scan.CLUSTERS[fused_scan.kernel_name(plan)]
    c_batch = fused_scan.CLUSTERS[fused_scan.BATCH_KERNEL_NAME]
    print(f"phase 10 (all blocks, {n} nodes x {p} pods, {plan.u} classes): one "
          f"{fused_scan.kernel_name(plan)} launch {s_ms:.1f} ms (cluster {c_single}) and one "
          f"batch launch of 3 node masks {b_ms:.1f} ms (cluster {c_batch}) == plain "
          f"({o_times[0]:.1f} ms one, {r_times[0]:.1f} ms the batch), placements and every "
          f"row [{gpu}]", flush=True)
    singles = cluster_sweep("phase 10", gpu, plan, batch, scen[:1], [one], (c_single, 1))
    batched = cluster_sweep("phase 10", gpu, plan, batch, scen, want, (c_batch, 1),
                            is_batch=True)
    b_ms_bound, b_by = bound(plan, cls, scen[:1])
    return {"ms": s_ms, "plain_ms": o_times[0], "max_abs_err": err, "bound_ms": b_ms_bound,
            "bound_by": b_by, "cluster": c_single, "prev_ms": singles[1],
            "batch_ms": b_ms, "batch_cluster": c_batch, "batch_prev_ms": batched[1]}


def phase11(gpu) -> dict:
    """The slice's path: the quickstart through the CLI on the card and
    on the CPU, byte for byte; then the full-width plan. Each plan's
    scans are held against the batch plain version."""
    import tempfile

    from open_simulator_tpu_torch.ops import fused_scan

    argv = ["apply", "-f", QUICKSTART, "--format", "json"]
    quick = plan_on_card(argv, cwd=ROOT)
    rc, cpu_out, err = run_cli(argv + ["--device", "cpu"], cwd=ROOT)
    doc, launches = quick["doc"], quick["launches"]
    if rc != 0 or quick["out"] != cpu_out:
        raise AssertionError(f"phase 11: the card's JSON differs from the CPU's (rc {rc}): "
                             f"{err[-1000:]}")
    if not doc["success"] or doc["newNodeCount"] != JAX_QUICKSTART_ANSWER:
        raise AssertionError(f"phase 11: success {doc['success']}, +{doc['newNodeCount']} "
                             f"nodes; the JAX package plans +{JAX_QUICKSTART_ANSWER}")
    plan = quick["sweep"].plan
    if not (plan.has_store and plan.has_terms) or (
            launches[fused_scan.STORE_TERMS_KERNEL_NAME] < 1):
        raise AssertionError(f"phase 11: the quickstart did not launch the storage and "
                             f"term instantiation: {launches}")
    print(f"phase 11: {' '.join(argv)} on the card ({quick['plan_s']:.3f} s) == --device "
          f"cpu, byte for byte ({len(cpu_out)} bytes): success, +{doc['newNodeCount']} node "
          f"(the JAX package's answer), launches {launches} [{gpu}]", flush=True)
    print(cpu_out.strip())
    hold_plan_scans("phase 11 (quickstart)", gpu, quick)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cfg = write_plan_config(root)
        print(f"phase 11: wrote the full-width plan ({PLAN_NODES} nodes) in "
              f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
        res = plan_on_card(["apply", "-f", cfg, "--format", "json", "--trace"])
    doc, launches = res["doc"], res["launches"]
    if not doc["success"] or doc["unscheduledPods"]:
        raise AssertionError(f"phase 11: full-width plan success {doc['success']}, "
                             f"{len(doc['unscheduledPods'])} unscheduled")
    if doc["newNodeCount"] != JAX_PLAN_ANSWER:
        raise AssertionError(f"phase 11: +{doc['newNodeCount']} nodes, the JAX package "
                             f"plans +{JAX_PLAN_ANSWER}")
    if (launches[fused_scan.STORE_TERMS_KERNEL_NAME] < 1
            or launches[fused_scan.BATCH_KERNEL_NAME] < 1):
        raise AssertionError(f"phase 11: the plan did not launch both kernels: {launches}")
    print_plan("phase 11 (full width, the JAX package's answer)", gpu, res)
    hold_plan_scans("phase 11 (full width)", gpu, res)
    plan = res["sweep"].plan
    pair = fused_scan.scratch_bytes(plan, 2, fused_scan.choose_cluster(plan, 2, True))
    many = fused_scan.scratch_bytes(plan, 101, fused_scan.choose_cluster(plan, 101, True))
    print(f"phase 11: scratch and block state {pair / 2**20:.1f} MiB for a pair, "
          f"{many / 2**30:.2f} GiB for 101 counts [{gpu}]", flush=True)
    return launches


def print_stream_build(lib):
    """Registers and spills of stream_kernel from nvcc's report."""
    entry = False
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line:
            entry = "stream_kernel" in line
        elif entry and ("registers" in line or "spill" in line):
            print(f"  ptxas stream_kernel: {line.strip()}")


def phase12(gpu) -> dict:
    """B7: the tool's entry point at its four sizes with the counter at
    0, each size's kernel == plain exactly, the 64 MiB size timed beside
    its plain version, its bound and one PyTorch reduction over the same
    bytes; then the scan-step probe."""
    import torch

    from open_simulator_tpu_torch.tools import stream_bench as sb

    l2 = sb.l2_bytes(0)
    sb.reset_launch_counts()
    rates = {mb: sb.run(mb, sb.tool_steps(mb)) for mb in sb.SIZES_MB}
    torch.cuda.synchronize()
    launches = sb.LAUNCHES[sb.KERNEL_NAME]
    if launches < len(sb.SIZES_MB):
        raise AssertionError(f"phase 12: run() launched {sb.KERNEL_NAME} {launches} times")
    res = {"launches": launches, "max_abs_err": 0}
    for mb in sb.SIZES_MB:
        steps = sb.tool_steps(mb)
        state = sb.make_state(mb, device="cuda")
        nbytes = state.numel() * 4
        regime = "in L2 after the first step" if nbytes <= l2 else "from device memory"
        got = sb.run_stream(state, steps)
        want, plain_ms = cuda_ms(lambda: sb.stream_reference(state, steps))
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"phase 12: {mb} MiB kernel != plain, max abs err {err}")
        print(f"phase 12: state {mb} MiB ({nbytes} bytes, {regime}; L2 {l2} bytes), "
              f"{steps} steps: run() {rates[mb]:.1f} GB/s; kernel == plain exactly "
              f"(plain {plain_ms:.1f} ms) [{gpu}]", flush=True)
        if mb == max(sb.SIZES_MB):
            times = [cuda_ms(lambda: sb.run_stream(state, steps))[1] for _ in range(3)]
            expanded = state.unsqueeze(0).expand(steps, -1, -1)
            torch.amax(expanded, dim=1)  # warm
            _out, lib_ms = cuda_ms(lambda: torch.amax(expanded, dim=1))
            bound_ms = nbytes * steps / HBM_BYTES_PER_S * 1e3
            res.update(ms=statistics.median(times), plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by="bytes")
            print(f"phase 12: {mb} MiB x {steps} steps: kernel {res['ms']:.3f} ms (median "
                  f"of 3: {[round(t, 3) for t in times]}) = "
                  f"{nbytes * steps / res['ms'] / 1e6:.1f} GB/s, plain {plain_ms:.1f} ms, "
                  f"torch.amax over the expanded state {lib_ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms by bytes [{gpu}]", flush=True)
        del state, got, want

    state = sb.make_state(PROBE_BYTES / 2**20, PROBE_BLOCK_ROWS, device="cuda")
    if state.numel() * 4 != PROBE_BYTES - PROBE_BYTES % (PROBE_BLOCK_ROWS * 512):
        raise AssertionError(f"phase 12: probe state {tuple(state.shape)}")
    sb.run_stream(state, 10)  # warm
    got, probe_ms = cuda_ms(lambda: sb.run_stream(state, PROBE_STEPS))
    want = sb.stream_reference(state, PROBE_STEPS)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"phase 12: scan-step probe kernel != plain, max abs err {err}")
    res["probe_us"] = probe_ms * 1e3 / PROBE_STEPS
    print(f"phase 12: scan-step probe, {state.shape[0]} rows ({state.numel() * 4} bytes) x "
          f"{PROBE_STEPS} steps over every SM with a grid barrier a step: {probe_ms:.3f} ms = "
          f"{res['probe_us']:.3f} us a step (B1: 38 us a pod step on one block); kernel == "
          f"plain [{gpu}]", flush=True)
    return res


def a2_inputs():
    """Phase 13's nodes and pods: the default scenario, pods cut."""
    return build_scenario(N_NODES, A2_PODS)


def a2_plugin(base):
    """Phase 13's custom score plugin on `base` (either package's
    SchedulerPlugin): a score of five levels from the node's zone and
    the pod's class, normalised min-max, so many nodes tie."""
    class ZoneClass(base):
        name = "zone-class"
        normalize = "minmax"

        def score(self, pod, node):
            zone = int(node["metadata"]["labels"]["zone"][1:])
            return (zone + len(pod["metadata"]["labels"]["cls"])) % 5

    return ZoneClass()


def a2_view(result, rng):
    """What phase 13 compares: every node's pods in order, the
    unscheduled pods with their reasons, and the RNG's 607-word history."""
    return {
        "nodes": [[ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods]]
                  for ns in result.node_status],
        "unscheduled": [[u.pod["metadata"]["name"], u.reason] for u in result.unscheduled_pods],
        "rng": [str(w) for w in rng.history()],
    }


def a2_digest(view) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(view, sort_keys=True).encode()).hexdigest()


def phase13(gpu) -> dict:
    """A2: simulate(engine="cuda", select_host="sample") with a custom
    plugin on the torch scan, on the card with the counters at 0, then
    the same call on the CPU and the JAX package's digest."""
    import copy

    import torch

    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.scheduler.core import AppResource, simulate
    from open_simulator_tpu_torch.scheduler.plugins import SchedulerPlugin, default_registry
    from open_simulator_tpu_torch.utils.gorand import GoRand
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    nodes, pods = a2_inputs()

    def run(device):
        cluster = ResourceTypes()
        cluster.nodes = copy.deepcopy(nodes)
        app = ResourceTypes()
        app.pods = copy.deepcopy(pods)
        reset_name_counter()
        GLOBAL.reset()
        rng = GoRand(A2_SEED)
        if device is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = simulate(cluster, [AppResource(A2_APP, app)], engine="cuda", device=device,
                          select_host="sample", rng=rng)
        if device is None:
            torch.cuda.synchronize()
        return {"view": a2_view(result, rng), "s": time.perf_counter() - t0,
                "notes": dict(GLOBAL.notes), "scan_s": GLOBAL.phase_seconds("engine/scan"),
                "placed": sum(len(ns.pods) for ns in result.node_status),
                "unscheduled": len(result.unscheduled_pods)}

    plugin = a2_plugin(SchedulerPlugin)
    default_registry.register(plugin)
    try:
        fused_scan.reset_launch_counts()
        card = run(None)
        launches = dict(fused_scan.LAUNCHES)
        cpu = run("cpu")
    finally:
        default_registry.unregister(plugin.name)
    want_note = 'torch-scan (custom score plugins and select_host="sample")'
    for label, r, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        notes = r["notes"]
        if notes.get("batch-kernel") != want_note or notes.get("scan-device") != dev:
            raise AssertionError(f"phase 13 ({label}): notes {notes}")
    if any(launches.values()):
        raise AssertionError(f"phase 13: the torch scan's batch launched a kernel: {launches}")
    if card["view"] != cpu["view"]:
        raise AssertionError("phase 13: the card's placements, reasons or RNG history differ "
                             "from the CPU run's")
    digest = a2_digest(card["view"])
    if digest != JAX_SAMPLE_ANSWER:
        raise AssertionError(f"phase 13: digest {digest}, the JAX package's is "
                             f"{JAX_SAMPLE_ANSWER}")
    p = len(pods)
    card_us, cpu_us = card["scan_s"] * 1e6 / p, cpu["scan_s"] * 1e6 / p
    print(f"phase 13 (A2, {N_NODES} nodes x {p} pods, sample + a min-max custom plugin): "
          f"simulate(engine='cuda') on the card == device='cpu' (placements, node status, "
          f"{card['unscheduled']} unscheduled with reasons, the RNG's 607 words) == the JAX "
          f"package's digest {digest[:16]}; fused launches {launches}; card {card['s']:.3f} s "
          f"end to end, engine/scan {card['scan_s'] * 1e3:.1f} ms = {card_us:.1f} us a pod "
          f"step (the CPU: {cpu['s']:.3f} s, {cpu_us:.1f} us a step) [{gpu}]", flush=True)
    return {"card_us": card_us, "cpu_us": cpu_us}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.tools import stream_bench
    from open_simulator_tpu_torch.utils import nvcc

    t_start = time.perf_counter()
    gpu = card()
    print(f"card: {gpu}", flush=True)

    # ---- phase 1: build both sources, their compilers started together
    t0 = time.perf_counter()
    lib, stream_lib = nvcc.build_libraries([fused_scan.SOURCE, stream_bench.SOURCE])
    print(f"phase 1: built {lib.name} and {stream_lib.name} in "
          f"{time.perf_counter() - t0:.2f} s [{gpu}]", flush=True)
    print_build(lib)
    print_stream_build(stream_lib)

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
    sweep = cluster_sweep("phase 2", gpu, plan, batch,
                          [(np.ones(p, bool), np.ones(n, bool), batch.pinned_node)],
                          [base.pop("want")], PHASE2_CLUSTERS)
    base["prev_ms"] = sweep[1]

    # ---- phase 3: the base main path
    base_launches = simulate_path("phase 3", gpu, nodes, pods, names, base["placements"],
                                  fused_scan.KERNEL_NAME)
    base["cluster"] = fused_scan.CLUSTERS[fused_scan.KERNEL_NAME]

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
    singles, s_times = timed(lambda: [fused_scan.run_fused_scan(plan, cls, a, v, pinned=q)
                                      for a, v, q in scenarios], 1)
    cut = prefix(scenarios, PHASE5_PLAIN_PODS)
    want, r_times = timed(lambda: fused_scan.fused_scan_batch_reference(plan, cls, cut), 1)
    batch_err = max(max_abs_err(g, w) for g, w in zip(
        fused_scan.run_fused_scan_batch(plan, cls, cut), want))
    single_err = max(max_abs_err(g, s) for g, s in zip(got, singles))
    if batch_err or single_err:
        raise AssertionError(f"phase 5: batch kernel != plain ({batch_err}) or != single "
                             f"launches ({single_err})")
    b_bound = bound(plan, cls, scenarios)
    print(f"phase 5: clusters of {fused_scan.CLUSTERS[fused_scan.BATCH_KERNEL_NAME]} blocks; "
          f"{len(scenarios)} scenarios in one batch launch == single launches, "
          f"and over their first {PHASE5_PLAIN_PODS} pods == batch plain; batch kernel "
          f"{statistics.median(b_times):.3f} ms (median of 3: "
          f"{[round(t, 3) for t in b_times]}), {len(scenarios)} single launches "
          f"{s_times[0]:.1f} ms, batch plain of the cut {r_times[0]:.1f} ms, bound "
          f"{b_bound[0]:.4f} ms by {b_bound[1]} [{gpu}]", flush=True)

    # ---- phase 6: the capacity plan through the CLI; B6's entry is
    # measured there, at the shapes of its main path
    del plan, g_plan, m_plan, got, want, singles
    torch.cuda.empty_cache()
    cap = phase6(gpu)
    base["max_abs_err"] = max(base["max_abs_err"], cap["single_err"])
    print(f"phases 1-6: {time.perf_counter() - t_start:.1f} s [{gpu}]", flush=True)

    # ---- phase 7: B3, bench.py's storage scenario, then the 6-VG shape
    s_nodes, s_pods = build_storage_scenario()
    store = block_phase(f"phase 7 (B3, {STOR_NODES} storage nodes x {STOR_PODS} pods)", gpu,
                        s_nodes, s_pods, fused_scan.STORE_KERNEL_NAME)
    f_nodes, f_pods = build_storage_scenario(n_pods=FALLBACK_PODS, n_vgs=FALLBACK_VGS)
    block_phase(f"phase 7b ({FALLBACK_VGS} VGs, pods cut to {FALLBACK_PODS})", gpu, f_nodes,
                f_pods, fused_scan.STORE_KERNEL_NAME, simulate=False)
    del s_nodes, s_pods, f_nodes, f_pods

    # ---- phase 8: B4, the affinity stress at 10,000 nodes
    a_nodes = affinity_nodes(AFF_NODES, AFF_ZONES)
    a_pods = expand(a_nodes, affinity_stateful_sets())
    terms = block_phase(f"phase 8 (B4, affinity stress, {AFF_NODES} nodes x {len(a_pods)} "
                        f"pods)", gpu, a_nodes, a_pods, fused_scan.TERMS_KERNEL_NAME)

    # ---- phase 9: B5, the same block at the JAX package's streamed size
    b5_nodes = affinity_nodes(B5_NODES, AFF_ZONES)
    b5_pods = expand(b5_nodes, affinity_stateful_sets())
    streamed = block_phase(f"phase 9 (B5, affinity stress, {B5_NODES} nodes x "
                           f"{len(b5_pods)} pods, plain over {B5_PLAIN_PODS})", gpu, b5_nodes,
                           b5_pods, fused_scan.TERMS_KERNEL_NAME, plain_pods=B5_PLAIN_PODS)
    del a_nodes, a_pods, b5_nodes, b5_pods
    torch.cuda.empty_cache()
    print(f"phases 7-9: {time.perf_counter() - t_start:.1f} s [{gpu}]", flush=True)

    # ---- phase 10: every block in one plan, single and batch
    mixed = phase10(gpu)

    # ---- phase 11: the slice's path through the CLI
    plan_launches = phase11(gpu)

    # ---- phase 12: B7, the streaming probe through its entry point
    stream = phase12(gpu)

    # ---- phase 13: A2, the torch scan under simulate()
    phase13(gpu)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s [{gpu}]", flush=True)

    def entry(name, replaces, launches, res):
        return {"name": name, "route": "cuda",
                "source": "open_simulator_tpu_torch/csrc/fused_scan.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None}

    print(gpu)  # nvidia-smi's own line: name, power limit
    print(json.dumps({"kernels": [
        dict(entry(fused_scan.KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:1690",
                   base_launches, base), cluster=base["cluster"], prev_ms=base["prev_ms"]),
        entry(fused_scan.EXT_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:1961",
              ext_launches, ext),
        dict(entry(fused_scan.BATCH_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:2974",
                   cap["launches"][fused_scan.BATCH_KERNEL_NAME], cap["batch"]),
             cluster=cap["batch"]["cluster"], prev_ms=cap["batch"]["prev_ms"]),
        dict(entry(fused_scan.STORE_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:2028",
                   store["launches"], store), cluster=store["cluster"],
             prev_ms=store["prev_ms"]),
        dict(entry(fused_scan.TERMS_KERNEL_NAME, "open_simulator_tpu/ops/pallas_scan.py:2106",
                   terms["launches"], terms), cluster=terms["cluster"],
             prev_ms=terms["prev_ms"]),
        dict(entry(f"{fused_scan.TERMS_KERNEL_NAME} at {B5_NODES} nodes",
                   "open_simulator_tpu/ops/pallas_scan.py:1914", streamed["launches"],
                   streamed), cluster=streamed["cluster"], prev_ms=streamed["prev_ms"]),
        dict(entry(fused_scan.STORE_TERMS_KERNEL_NAME,
                   "open_simulator_tpu/ops/pallas_scan.py:2028",
                   plan_launches[fused_scan.STORE_TERMS_KERNEL_NAME], mixed),
             cluster=mixed["cluster"], prev_ms=mixed["prev_ms"]),
        dict(entry(stream_bench.KERNEL_NAME, "tools/stream_bench.py:31", stream["launches"],
                   stream), source="open_simulator_tpu_torch/csrc/stream_bench.cu",
             library_ms=stream["library_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
