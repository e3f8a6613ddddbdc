"""On-demand queries against the live mirror — what-if, drain safety,
N+K survivability, capacity forecast — all answered from WARM state
(the port's copy of the JAX package's twin/queries.py).

Every query follows the same shape: under the mirror lock, build the
question as (unbound pods, node-validity mask), answer it with ONE
masked scan over the warm engine's current dynamic state
(``TorchEngine.scan_active(active, valid=...)`` — the chaos substrate's
per-scenario node mask, so a drain question is literally an outage
scenario row evaluated against live state), then mirror the placements
into a scratch host oracle for failure reasons that read their own
step's state (the engine-replay contract of scheduler/engine.py).
On the cuda engine that scan is one launch of the fused-scan kernel
(B1 on a base plan) on the mirror's device: a what-if, a drain and
each N+K trial launch it once, and never move to the serial walk.
Nothing commits: the mirror is read, never mutated, and the already
built kernel library launches again (zero nvcc builds on repeat
queries — the serve property, now against live state).

The capacity forecast is the timeline bridge: the mirrored state
snapshots into a loadable cluster (``ClusterMirror.snapshot_cluster``),
the mirror's pending pods requeue as arrivals THROUGH the delta
substrate (``deltas_to_events``), synthetic future arrivals extend the
stream, and the windowed stepper (timeline/stepper.py) steps it
forward — "what happens to pending at 2x the current arrival rate"
answered from the cluster as it is right now. On the cuda engine each
window is one pins-first launch of the batch kernel. Unlike the JAX
package, whose forecast defaults to the serial oracle, the forecast
runs on the mirror's engine and device unless the query names one.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.validation import InputError
from ..utils.trace import COUNTERS

#: forecast arrival-stream cap (one query must stay bounded even at a
#: silly rate x horizon product); overflow is reported, never silent
FORECAST_MAX_ARRIVALS = 5000


def _pod_key(pod: dict) -> Tuple[str, str]:
    meta = (pod or {}).get("metadata") or {}
    return (meta.get("namespace") or "default", meta.get("name", ""))


def _unbind(pod: dict) -> dict:
    """A committed pod back in its schedulable form (the evict_pod
    strip: binding, phase, GPU device stamp)."""
    from ..models import storage as stor

    q = copy.deepcopy(pod)
    (q.get("spec") or {}).pop("nodeName", None)
    q.pop("status", None)
    anno = (q.get("metadata") or {}).get("annotations")
    if anno:
        anno.pop(stor.GPU_INDEX_ANNO, None)
    return q


def _expand_apps(apps, nodes: List[dict]) -> List[dict]:
    """Expand request apps exactly like a standalone run (the serve
    Session's expansion: counter reset, apps in order, each app's pods
    through the queue sorts)."""
    from ..models import workloads as wl
    from ..scheduler.core import _sort_app_pods

    wl.reset_name_counter()
    pods: List[dict] = []
    for app in apps:
        app_pods = wl.generate_valid_pods_from_app(app.name, app.resource, nodes)
        pods.extend(_sort_app_pods(app_pods))
    return pods


def _scan_pods(mirror, pods: List[dict], valid: Optional[np.ndarray]) -> np.ndarray:
    """Placements for `pods` against the mirror's CURRENT state with
    candidate nodes gated by `valid`: one masked-scan launch on the
    cuda engine, or the serial probe walk on the host oracle.
    Returns placements[P]: node index, -1 unschedulable, or -3 for
    dangling pods (unknown spec.nodeName — tracked, never scheduled)."""
    oracle = mirror.oracle
    node_index = oracle.node_index
    out = np.full(len(pods), -3, dtype=np.int64)
    batch_idx = []
    for i, pod in enumerate(pods):
        name = (pod.get("spec") or {}).get("nodeName")
        if name and name not in node_index:
            continue
        batch_idx.append(i)
    if not batch_idx:
        return out
    engine = mirror.engine
    if engine is not None:
        COUNTERS.inc("twin_query_dispatches_total")
        # the twin IS the incremental design: the mirror's committed
        # pods are warm state, the query pods are the dispatched
        # suffix — account them in the same counter family the serve
        # committed scan feeds (incremental/store.incremental_block).
        # The O(nodes) pod-count walk is noise next to the query's own
        # scratch replay (which re-places every committed pod)
        COUNTERS.inc("incremental_suffix_pods_total", len(batch_idx))
        COUNTERS.inc(
            "incremental_prefix_reused_pods_total",
            sum(len(ns.pods) for ns in oracle.nodes),
        )
        engine.begin_batch([pods[i] for i in batch_idx])
        placements = engine.scan_active(
            np.ones(len(batch_idx), dtype=bool), valid=valid
        )
        for pos, i in enumerate(batch_idx):
            out[i] = int(placements[pos])
        return out
    # serial probe walk (engine="oracle"): same semantics as the scan —
    # sequential commit on a scratch oracle, NO preemption (queries are
    # probes; the read-only contract of shadow/replay.py)
    scratch = _scratch_oracle(mirror, valid)
    for i in batch_idx:
        pod = copy.deepcopy(pods[i])
        name = (pod.get("spec") or {}).get("nodeName")
        if name:
            scratch.place_existing_pod(pod)
            out[i] = node_index[name]
            continue
        feasible, _reasons, _codes = scratch._find_feasible(pod)
        if valid is not None:
            # cordoned nodes exist but take no new pods (the scan path
            # gets this from its node_valid mask)
            feasible = [ns for ns in feasible if bool(valid[ns.index])]
        if not feasible:
            out[i] = -1
            continue
        scores = scratch._prioritize(pod, feasible)
        best, best_score = feasible[0], scores[0]
        for ns, sc in zip(feasible[1:], scores[1:]):
            if sc > best_score:
                best, best_score = ns, sc
        scratch._reserve_and_bind(pod, best)
        out[i] = node_index[best.name]
    return out


def _scratch_oracle(mirror, valid: Optional[np.ndarray], exclude_pods=frozenset()):
    """A disposable host oracle mirroring the current committed state:
    same node list (so placements carry over by index), every committed
    pod re-placed except `exclude_pods` keys, nodes outside `valid`
    left empty (their pods are the displaced set being rescheduled).
    Mutating it never touches the mirror."""
    from ..scheduler.oracle import Oracle

    live = mirror.oracle
    base = mirror.replayer.cluster
    scratch = Oracle(
        [ns.node for ns in live.nodes],
        pdbs=base.pod_disruption_budgets,
        priority_classes=base.priority_classes,
    )
    for idx, ns in enumerate(live.nodes):
        if valid is not None and not bool(valid[idx]):
            continue
        for p in ns.pods:
            if _pod_key(p) in exclude_pods:
                continue
            scratch.place_existing_pod(copy.deepcopy(p))
    return scratch


def _failure_reason(scratch, pod: dict, valid: Optional[np.ndarray], n_masked: int) -> str:
    """The standalone-run failure message at this pod's own step state,
    with masked-off nodes accounted as a scenario reason (the drain /
    outage questions cordon nodes; the message must say so instead of
    pretending the cluster shrank)."""
    from ..scheduler.oracle import Oracle

    reasons: Dict[str, int] = {}
    ctx = scratch._pod_filter_ctx(pod)
    pre = scratch._prefilter(pod)
    for idx, ns in enumerate(scratch.nodes):
        if valid is not None and not bool(valid[idx]):
            continue
        r = scratch._check_node(pod, ctx, pre, ns)
        if r is not None:
            reasons[r[0]] = reasons.get(r[0], 0) + 1
    if n_masked:
        reasons["node(s) cordoned in this scenario"] = n_masked
    return Oracle._failure_message(pod, reasons)


def _answer(mirror, pods, placements, valid, exclude=frozenset()) -> dict:
    """Mirror scan placements into a scratch oracle in scan order and
    produce the canonical answer: placements for scheduled pods,
    standalone-formula reasons for failures (computed at each
    failure's own step state — a later pod's failure sees the earlier
    pods' placements, exactly like a standalone run)."""
    scratch = _scratch_oracle(mirror, valid, exclude_pods=exclude)
    n_masked = 0 if valid is None else int((~np.asarray(valid, bool)).sum())
    placed, failed, dangling = [], [], []
    for i, pod in enumerate(pods):
        place = int(placements[i])
        ns_name, name = _pod_key(pod)
        pod2 = copy.deepcopy(pod)
        if place == -3:
            dangling.append({"namespace": ns_name, "name": name})
            continue
        if (pod.get("spec") or {}).get("nodeName"):
            scratch.place_existing_pod(pod2)
            placed.append(
                {"namespace": ns_name, "name": name,
                 "node": pod["spec"]["nodeName"], "pinned": True}
            )
        elif place < 0:
            failed.append({
                "namespace": ns_name,
                "name": name,
                "reason": _failure_reason(scratch, pod2, valid, n_masked),
            })
        else:
            node = scratch.nodes[place]
            scratch._reserve_and_bind(pod2, node)
            placed.append(
                {"namespace": ns_name, "name": name, "node": node.name}
            )
    return {
        "success": not failed,
        "placed": len(placed),
        "failedCount": len(failed),
        "placements": placed,
        "unscheduledPods": failed,
        "danglingPods": dangling,
    }


# -- the four queries ----------------------------------------------------


def whatif(mirror, apps) -> dict:
    """POST /v1/whatif: would these apps fit RIGHT NOW? One warm scan
    of the expanded request against current mirrored state."""
    with mirror.lock:
        COUNTERS.inc("twin_whatif_total")
        pods = _expand_apps(apps, [ns.node for ns in mirror.oracle.nodes])
        placements = _scan_pods(mirror, pods, valid=None)
        out = _answer(mirror, pods, placements, valid=None)
        out["kind"] = "whatif"
        out["mirror"] = mirror.stats()
        return out


def resolve_drain_set(mirror, nodes=(), selector=None) -> List[int]:
    """Node indices to cordon: explicit names plus a label selector
    (``{"rack": "r7"}`` cordons rack 7). Caller holds the lock."""
    oracle = mirror.oracle
    picked = set()
    for name in nodes or ():
        idx = oracle.node_index.get(str(name))
        if idx is None:
            raise InputError(f"drain names unknown node {name!r}")
        picked.add(int(idx))
    if selector:
        if not isinstance(selector, dict):
            raise InputError("drain selector must be an object of node labels")
        for idx, ns in enumerate(oracle.nodes):
            labels = ns.labels
            if all(labels.get(k) == v for k, v in selector.items()):
                picked.add(idx)
    if not picked:
        raise InputError("drain resolved no nodes (names empty, selector matched nothing)")
    if len(picked) >= len(oracle.nodes):
        raise InputError("drain would cordon every node in the cluster")
    return sorted(picked)


def _evaluate_outage(mirror, drained: List[int]) -> dict:
    """One outage scenario against live state: pods of the drained
    nodes become the displaced set (daemonset-owned pods die with the
    node — the chaos displacement rule), the scan re-places them with
    the drained nodes masked invalid, the scratch replay yields
    reasons. Caller holds the lock."""
    from ..models.kubeclient import _owned_by_daemonset

    oracle = mirror.oracle
    valid = np.ones(len(oracle.nodes), dtype=bool)
    valid[drained] = False
    displaced, lost_ds = [], 0
    exclude = set()
    for idx in drained:
        for p in oracle.nodes[idx].pods:
            if _owned_by_daemonset(p):
                lost_ds += 1
                continue
            displaced.append(_unbind(p))
            exclude.add(_pod_key(p))
    placements = _scan_pods(mirror, displaced, valid=valid)
    out = _answer(mirror, displaced, placements, valid=valid, exclude=exclude)
    out["drainedNodes"] = [oracle.nodes[i].name for i in drained]
    out["displaced"] = len(displaced)
    out["lostDaemonSetPods"] = lost_ds
    out["safe"] = out["success"]
    return out


def drain(mirror, nodes=(), selector=None) -> dict:
    """POST /v1/drain: can I cordon these nodes (this rack) right now
    without stranding their pods? The displaced pods re-simulate
    against the remaining live capacity via the chaos substrate's
    node-validity mask — one warm launch."""
    with mirror.lock:
        COUNTERS.inc("twin_drain_total")
        drained = resolve_drain_set(mirror, nodes=nodes, selector=selector)
        out = _evaluate_outage(mirror, drained)
        out["kind"] = "drain"
        out["mirror"] = mirror.stats()
        return out


def nplusk(mirror, k: int = 1, trials: int = 32, seed: int = 1) -> dict:
    """POST /v1/nplusk: does the LIVE placement survive any K-node
    outage? Exhaustive when the scenario space fits in ``trials``,
    seeded-sampled otherwise (resilience/chaos.sampled_failure_sets —
    the N+K machinery of `simon chaos`, pointed at mirrored state)."""
    from ..resilience.chaos import sampled_failure_sets

    if k < 1:
        raise InputError(f"nplusk k must be >= 1, got {k}")
    if trials < 1:
        raise InputError(f"nplusk trials must be >= 1, got {trials}")
    with mirror.lock:
        COUNTERS.inc("twin_nplusk_total")
        n = len(mirror.oracle.nodes)
        if k >= n:
            raise InputError(f"cannot fail {k} of {n} node(s)")
        combos, mode = sampled_failure_sets(list(range(n)), k, trials, seed)
        survived = 0
        worst = None
        scenarios = []
        for combo in combos:
            res = _evaluate_outage(mirror, list(combo))
            ok = res["safe"]
            survived += 1 if ok else 0
            scenarios.append({
                "nodes": res["drainedNodes"],
                "safe": ok,
                "displaced": res["displaced"],
                "unplaced": res["failedCount"],
            })
            if not ok and (worst is None or res["failedCount"] > worst["unplaced"]):
                worst = scenarios[-1]
        return {
            "kind": "nplusk",
            "k": k,
            "mode": mode,
            "scenarios": len(combos),
            "survived": survived,
            "survivable": survived == len(combos),
            "worst": worst,
            "outages": scenarios,
            "mirror": mirror.stats(),
        }


def forecast(
    mirror,
    horizon_s: float,
    arrival_rate: Optional[float] = None,
    rate_scale: float = 1.0,
    seed: int = 1,
    policy: str = "static:0",
    cadence_s: float = 60.0,
    warmup_s: float = 0.0,
    max_nodes: int = 0,
    new_node_spec: Optional[dict] = None,
    engine: Optional[str] = None,
    mean_lifetime_s: float = 600.0,
    budget=None,
) -> dict:
    """POST /v1/forecast: timeline windows stepped forward from the
    CURRENT mirrored state. The mirror's pending pods requeue at t=0
    (through the delta substrate), synthetic arrivals extend the
    stream at ``arrival_rate`` (default: the observed decision rate of
    the tail, scaled by ``rateScale``), and the windowed stepper races
    the requested autoscaler policy over it, on ``engine`` (default:
    the mirror's, on the mirror's device)."""
    import time as _time

    from ..timeline.autoscaler import parse_policies
    from ..timeline.compare import run_policies
    from ..timeline.events import EventHeap, SyntheticSpec, generate_synthetic
    from .deltas import POD_ARRIVE, ClusterDelta, deltas_to_events

    if horizon_s <= 0:
        raise InputError(f"forecast horizon must be > 0s, got {horizon_s}")
    if rate_scale <= 0:
        raise InputError(f"forecast rateScale must be > 0, got {rate_scale}")
    with mirror.lock:
        COUNTERS.inc("twin_forecast_total")
        snapshot = mirror.snapshot_cluster()
        pending = [copy.deepcopy(p) for p in mirror.applicator.pending.values()]
        decisions = mirror.replayer.report.decisions
        uptime = max(_time.monotonic() - mirror.started_at, 1e-9)
    if engine is None:
        engine = mirror.replayer.engine_kind
    device = mirror.device
    if device is None:
        # an oracle mirror: its serial windows do no device work; a
        # cuda forecast asked of it needs the card (400 without one)
        from ..ops.fused_scan import NoCardError, resolve_device

        try:
            device = resolve_device(None) if engine == "cuda" else "cpu"
        except NoCardError as e:
            raise InputError(str(e)) from e
    rate = arrival_rate
    if rate is None:
        observed = decisions / uptime
        rate = observed * rate_scale
    else:
        rate = rate * rate_scale
    arrivals = int(rate * horizon_s)
    truncated = False
    if arrivals > FORECAST_MAX_ARRIVALS:
        arrivals, truncated = FORECAST_MAX_ARRIVALS, True
    if arrivals <= 0 and not pending:
        return {
            "kind": "forecast",
            "horizonSeconds": horizon_s,
            "arrivalRate": rate,
            "arrivals": 0,
            "pendingSeeded": 0,
            "policies": [],
            "note": "nothing to forecast: no pending pods and a zero arrival rate",
        }
    node_names = [
        (n.get("metadata") or {}).get("name", "") for n in snapshot.nodes
    ]
    # pending pods requeue at t=0 through the substrate bridge; seqs
    # re-stamp in push order so merged pending + synthetic streams
    # stay a canonical, strictly-ordered trace
    heap = EventHeap()
    for ev in deltas_to_events(
        [ClusterDelta(kind=POD_ARRIVE, pod=p) for p in pending],
        t0=0.0,
        spacing=0.0,
    ):
        ev.seq = -1
        heap.push(ev)
    if arrivals > 0:
        spec = SyntheticSpec(
            arrivals=arrivals,
            arrival_rate=rate,
            mean_lifetime_s=mean_lifetime_s,
            seed=seed,
        )
        for ev in generate_synthetic(spec, node_names):
            if ev.time <= horizon_s:
                ev.seq = -1
                heap.push(ev)
    events = heap.drain()
    cmp_ = run_policies(
        snapshot,
        events,
        parse_policies([policy]),
        new_node_spec=new_node_spec,
        max_nodes=max_nodes,
        cadence_s=cadence_s,
        warmup_s=warmup_s,
        engine=engine,
        budget=budget,
        device=device,
    )
    out = {
        "kind": "forecast",
        "horizonSeconds": horizon_s,
        "arrivalRate": round(rate, 6),
        "arrivals": arrivals,
        "truncated": truncated,
        "pendingSeeded": len(pending),
        "windows": cmp_.windows,
        "dispatches": cmp_.dispatches,
        "engine": cmp_.engine,
        "policies": [
            {
                "policy": tl.policy,
                "final": tl.final.as_dict() if tl.final else None,
                "peakPending": tl.peak_pending,
                "peakNodes": tl.peak_nodes,
                "decisions": len(tl.decisions),
                "displaced": tl.displaced_total,
            }
            for tl in cmp_.policies
        ],
    }
    return out
