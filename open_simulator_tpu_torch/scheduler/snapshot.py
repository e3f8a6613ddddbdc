"""Cluster snapshot: serialize/restore simulation state (the port's copy
of the JAX package's scheduler/snapshot.py).

The reference has no persistence — every run rebuilds the fake cluster
from YAML (SURVEY.md §5: checkpoint/resume absent; the `simulator-plan`
ConfigMap constants are vestigial). Here a snapshot is first-class:
the full post-simulation cluster (nodes with mutated storage/GPU
annotations + placed pods) round-trips through one JSON file, enabling

- checkpoint/resume: continue deploying more apps onto a prior result
- defragmentation/what-if studies on a captured cluster state
- exporting a simulated cluster as the customConfig of a new run
"""

from __future__ import annotations

import json

from ..models.decode import ResourceTypes
from .core import NodeStatus, SimulateResult, Simulator

SNAPSHOT_VERSION = 1


def snapshot_to_dict(result: SimulateResult, cluster: ResourceTypes = None) -> dict:
    out = {
        "version": SNAPSHOT_VERSION,
        "nodes": [ns.node for ns in result.node_status],
        "pods": [p for ns in result.node_status for p in ns.pods],
        "unscheduled": [
            {"pod": up.pod, "reason": up.reason} for up in result.unscheduled_pods
        ],
    }
    # cluster-scoped scheduling config (PDBs feed DefaultPreemption,
    # PriorityClasses the admission emulation) so a resumed simulator
    # agrees with a fresh simulate() on identical state
    if cluster is not None:
        out["podDisruptionBudgets"] = list(cluster.pod_disruption_budgets)
        out["priorityClasses"] = list(cluster.priority_classes)
    return out


def save_snapshot(result: SimulateResult, path: str, cluster: ResourceTypes = None):
    with open(path, "w") as f:
        json.dump(snapshot_to_dict(result, cluster), f)


def load_snapshot(path: str) -> SimulateResult:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"snapshot must be a JSON object, got {type(data).__name__}")
    if data.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version: {data.get('version')}")
    if not isinstance(data.get("nodes"), list) or not isinstance(data.get("pods"), list):
        raise ValueError("snapshot missing 'nodes'/'pods' lists")
    by_node = {}
    statuses = [NodeStatus(node=n, pods=[]) for n in data["nodes"]]
    for st in statuses:
        by_node[(st.node.get("metadata") or {}).get("name", "")] = st
    for pod in data["pods"]:
        name = (pod.get("spec") or {}).get("nodeName")
        if name in by_node:
            by_node[name].pods.append(pod)
    from .core import UnscheduledPod

    result = SimulateResult(
        unscheduled_pods=[
            UnscheduledPod(pod=u["pod"], reason=u["reason"]) for u in data.get("unscheduled", [])
        ],
        node_status=statuses,
    )
    # carried alongside (not part of the scheduling result proper);
    # resume_simulator picks these up
    result.snapshot_extras = {
        "pdbs": data.get("podDisruptionBudgets") or [],
        "priority_classes": data.get("priorityClasses") or [],
    }
    return result


def resume_simulator(
    result: SimulateResult,
    engine: str = "cuda",
    pdbs=None,
    priority_classes=None,
    device=None,
) -> Simulator:
    """Rebuild a live Simulator from a snapshot: nodes re-admitted with
    their mutated annotations, pods re-placed with their bindings (GPU
    devices honored via the gpu-index annotation). PDBs and
    PriorityClasses default to what load_snapshot carried
    (snapshot_extras) so preemption on the resumed simulator matches a
    fresh simulate(). The cuda engine's scans run on `device` (the card
    unless the caller names another).

    Always resumes with the default first-max selectHost: the "sample"
    mode's RNG stream position is not part of a snapshot (Go's global
    rand has no checkpoint either), so a sample-mode run cannot be
    resumed stream-faithfully — re-run it fresh instead."""
    extras = getattr(result, "snapshot_extras", {}) or {}
    if pdbs is None:
        pdbs = extras.get("pdbs") or []
    if priority_classes is None:
        priority_classes = extras.get("priority_classes") or []
    sim = Simulator(engine=engine, device=device)
    cluster = ResourceTypes()
    cluster.nodes = [ns.node for ns in result.node_status]
    from .oracle import Oracle

    sim.oracle = Oracle(cluster.nodes, pdbs=pdbs, priority_classes=priority_classes)
    for ns in result.node_status:
        for pod in ns.pods:
            sim.oracle.place_existing_pod(pod)
            sim.cluster_pods.append(pod)
    return sim


def cluster_from_snapshot(result: SimulateResult) -> ResourceTypes:
    """Snapshot -> ResourceTypes, keeping only non-daemonset running
    pods, mirroring CreateClusterResourceFromClient's filter
    (simulator.go:369-441: keeps Running pods without a DaemonSet
    owner)."""
    res = ResourceTypes()
    res.nodes = [ns.node for ns in result.node_status]
    for ns in result.node_status:
        for pod in ns.pods:
            refs = (pod.get("metadata") or {}).get("ownerReferences") or []
            if any(r.get("kind") == "DaemonSet" for r in refs):
                continue
            if ((pod.get("status") or {}).get("phase")) not in (None, "Running"):
                continue
            res.pods.append(pod)
    return res
