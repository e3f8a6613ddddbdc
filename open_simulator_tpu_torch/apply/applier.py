"""The capacity planner ("Applier").

Mirrors pkg/apply/apply.go, ported from the JAX package's
apply/applier.py:
- Simon CR config parsing (apiVersion simon/v1alpha1, kind Config;
  pkg/api/v1alpha1/types.go) with path validation (apply.go:249-286)
- the cluster from a customConfig dir or a live cluster's kubeConfig
  (models/kubeclient.py); the app list from plain YAML dirs or Helm charts (models/chart.py, the reference's pkg/chart rendering)
- the capacity loop (apply.go:186-239): instead of interactively asking
  the user for a node count per iteration, candidate counts up to
  MaxNumNewNode are evaluated via bisection probes over ONE encoded
  padded cluster (parallel/sweep.py), each probe one fused-scan kernel
  launch on the card and a pair of probes one scenario-batch launch
- utilization caps from MaxCPU/MaxMemory/MaxVG env vars
  (satisfyResourceSetting, apply.go:611-697)
- N+K planning (`tolerate_node_failures`): the plan escalates until its
  committed placement survives every evaluated K-node outage
  (resilience/chaos.py raise_plan_to_nplusk, on the batch kernel's
  pins-first mode)
- the resumable journal (`journal_path` / `resume_path`,
  runtime/journal.py) and the multi-spec what-if (`probe_plan_multi`)

Engines: "cuda" (the default) plans through the sweep on `device` (None
= the card; it raises without one, `device="cpu"` runs the kernels'
plain versions); "oracle" runs the serial escalation loop from the
sweep's hint. A batch with custom score plugins probes on the torch
scan (parallel/sweep.py), trace-noted. Kernel, build and launch errors
propagate: the only route from the batched plan to the serial loop is a
priority-bearing (or permit/stateful-plugin) workload, which the scan
cannot model (PrioritySignalError), and that route is trace-noted.
The interactive shell (`simon apply -i`) is apply/interactive.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

from ..models import storage as stor
from ..models import workloads as wl
from ..models.chart import process_chart
from ..models.cluster import cluster_from_config_dir, match_and_set_local_storage
from ..models.decode import (
    ResourceTypes,
    decode_yaml_content,
    load_directory,
    yaml_content_from_directory,
)
from ..models.validation import InputError
from ..runtime.errors import ConformanceError
from ..scheduler.core import AppResource, SimulateResult, simulate
from ..utils.memo import clear_all_memos
from .report import report

MAX_NUM_NEW_NODE = wl.MAX_NUM_NEW_NODE


@dataclass
class AppInfo:
    name: str
    path: str
    chart: bool = False


@dataclass
class SimonConfig:
    custom_cluster: Optional[str] = None
    kube_config: Optional[str] = None
    app_list: List[AppInfo] = field(default_factory=list)
    new_node: Optional[str] = None

    @classmethod
    def from_file(cls, path: str) -> "SimonConfig":
        import yaml  # only YAML ingestion needs PyYAML

        with open(path) as f:
            doc = yaml.safe_load(f)
        if not isinstance(doc, dict) or doc.get("kind") != "Config":
            raise InputError(f"{path}: not a simon Config object")
        spec = doc.get("spec") or {}
        cluster = spec.get("cluster") or {}
        apps = [
            AppInfo(
                name=a.get("name", ""),
                path=a.get("path", ""),
                chart=bool(a.get("chart", False)),
            )
            for a in spec.get("appList") or []
        ]
        return cls(
            custom_cluster=cluster.get("customConfig"),
            kube_config=cluster.get("kubeConfig"),
            app_list=apps,
            new_node=spec.get("newNode"),
        )

    def validate(self):
        """Path validation (apply.go:249-286)."""
        if bool(self.custom_cluster) == bool(self.kube_config):
            raise InputError(
                "only one of values of both kubeConfig and customConfig must exist"
            )
        if self.kube_config and not os.path.exists(os.path.expanduser(self.kube_config)):
            raise InputError(f"invalid path of kubeconfig: {self.kube_config}")
        if self.custom_cluster and not os.path.exists(self.custom_cluster):
            raise InputError(f"invalid path of customConfig: {self.custom_cluster}")
        if self.new_node and not os.path.exists(self.new_node):
            raise InputError(f"invalid path of newNode: {self.new_node}")
        for app in self.app_list:
            if not os.path.exists(app.path):
                raise InputError(f"invalid path of {app.name} app: {app.path}")


def _resource_caps():
    """MaxCPU/MaxMemory/MaxVG env caps, clamped to [0,100] like
    apply.go:611-641."""

    def cap(env):
        raw = os.environ.get(env, "")
        if not raw:
            return 100
        v = int(raw)
        return 100 if v > 100 or v < 0 else v

    return cap("MaxCPU"), cap("MaxMemory"), cap("MaxVG")


def satisfy_resource_setting(node_statuses, oracle=None) -> tuple:
    """satisfyResourceSetting (apply.go:611-697). With `oracle` (the
    replay oracle whose NodeStates back these statuses), per-node
    floor totals come from the commit-time aggregates instead of a
    100k-pod re-walk."""
    from ..models import requests as req
    from .report import _pod_req_summary, matched_node_state, node_state_index

    max_cpu, max_mem, max_vg = _resource_caps()
    total_alloc_cpu = total_alloc_mem = 0
    total_used_cpu = total_used_mem = 0
    vg_cap = vg_req = 0
    by_node = node_state_index(oracle)
    for status in node_statuses:
        node = status.node
        total_alloc_cpu += req.node_alloc_milli_cpu(node)
        total_alloc_mem += req.node_alloc_int(node, req.MEMORY)
        state = matched_node_state(by_node, status)
        if state is not None:
            total_used_cpu += state.req_floor_mcpu
            total_used_mem += state.req_floor_mem
        else:
            for pod in status.pods:
                mcpu, mem = _pod_req_summary(pod)
                total_used_cpu += mcpu
                total_used_mem += mem
        storage = stor.parse_node_storage(node)
        if storage:
            for vg in storage.vgs:
                vg_cap += vg.capacity
                vg_req += vg.requested
    cpu_rate = int(total_used_cpu / total_alloc_cpu * 100) if total_alloc_cpu else 0
    mem_rate = int(total_used_mem / total_alloc_mem * 100) if total_alloc_mem else 0
    if cpu_rate > max_cpu:
        return False, (
            f"the average occupancy rate({cpu_rate}%) of cpu goes beyond the env setting({max_cpu}%)"
        )
    if mem_rate > max_mem:
        return False, (
            f"the average occupancy rate({mem_rate}%) of memory goes beyond the env setting({max_mem}%)"
        )
    if vg_cap:
        vg_rate = int(vg_req / vg_cap * 100)
        if vg_rate > max_vg:
            return False, (
                f"the average occupancy rate({vg_rate}%) of vg goes beyond the env setting({max_vg}%)"
            )
    return True, ""


@dataclass
class ApplyResult:
    success: bool
    new_node_count: int
    result: Optional[SimulateResult]
    report_text: str = ""
    message: str = ""


MAX_DETAILED_REASONS = 50


def replay_scenario(sweep, count: int, placements):
    """Rebuild host-side oracle state from one capacity scenario's scan
    placements (the first `count` candidate nodes enabled). See
    replay_masked for the general form."""
    return replay_masked(sweep, sweep.node_valid(count), placements)


def replay_masked(sweep, valid, placements):
    """Rebuild host-side oracle state from one masked scenario's scan
    placements (the same binding code the serial path uses — the
    engine-replay contract of scheduler/engine.py), producing the
    SimulateResult for reports. `valid[n]` names the nodes that exist
    in the scenario. Returns (result, oracle).

    Exact per-node failure reasons cost a full serial filter pass per
    failed pod (O(nodes) Python), so only the first MAX_DETAILED_REASONS
    failures get them; the rest carry a summary reason. Classes with
    GPU/storage side effects replay through the oracle's general bind,
    which recomputes the GPU device choice on the host."""
    import numpy as np

    from ..obs.explain import EXPLAIN
    from ..scheduler.core import NodeStatus, SimulateResult, UnscheduledPod
    from ..scheduler.engine import build_bulk_tables
    from ..scheduler.oracle import ClassCommitCache, Oracle, simple_commit_mask
    from ..utils.trace import phase

    if EXPLAIN.enabled:
        EXPLAIN.set_context(engine="capacity-replay")
    valid = np.asarray(valid)
    kept = [i for i in range(len(sweep.oracle.nodes)) if valid[i]]
    nodes = [sweep.oracle.nodes[i].node for i in kept]
    oracle = Oracle(nodes)
    # sweep node index -> local replay index, vectorized (-1 unknown)
    local_of_arr = np.full(len(sweep.oracle.nodes) + 1, -1, dtype=np.int64)
    for local_i, sweep_i in enumerate(kept):
        local_of_arr[sweep_i] = local_i
    # classes with no GPU/storage side effects take a minimal bind, and
    # contiguous runs of them commit in BULK (oracle.commit_simple_bulk)
    batch = sweep.batch
    simple_class = simple_commit_mask(batch, bool(sweep.oracle.extenders))
    field_tbl, ports_of, scalars_of, bulk_ok = build_bulk_tables(
        batch, simple_class
    )
    class_of_pod = np.asarray(batch.class_of_pod, dtype=np.int64)
    had_node_name = np.asarray(sweep.had_node_name, dtype=bool)
    place_arr = np.asarray(placements, dtype=np.int64)
    pods = sweep.pods
    failed = []
    commit_cache = ClassCommitCache()
    with phase("engine/replay"):
        # event pods (inactive / pinned / failed / side-effect classes)
        # take the exact per-pod path in order; runs between them bulk
        bulk_mask = (
            (place_arr >= 0)
            & ~had_node_name
            & simple_class[class_of_pod]
            & bulk_ok[class_of_pod]
        )
        if EXPLAIN.enabled and EXPLAIN.target is not None:
            want = np.fromiter(
                (EXPLAIN.wants(p) for p in pods), dtype=bool, count=len(pods)
            )
            bulk_mask &= ~want

        def bulk(a, b):
            if b <= a:
                return
            local = local_of_arr[place_arr[a:b]]
            if (local < 0).any():
                # a placement names a node outside this scenario's mask
                # — scan invariant violation; fail loudly with the
                # taxonomy's internal-defect error
                bad = int(place_arr[a:b][local < 0][0])
                raise ConformanceError(
                    f"placement on masked-off node index {bad}"
                )
            # prios=None is exact here: CapacitySweep refuses any
            # priority-bearing pod at construction (PrioritySignalError)
            oracle.commit_simple_bulk(
                pods[a:b],
                local,
                class_of_pod[a:b],
                field_tbl, ports_of, scalars_of,
            )

        prev = 0
        for p_i in np.flatnonzero(~bulk_mask).tolist():
            bulk(prev, p_i)
            prev = p_i + 1
            pod = pods[p_i]
            idx = int(place_arr[p_i])
            if idx == -2:  # inactive in this scenario (disabled-node ds pod)
                continue
            # original pins only: a previous replay may have written
            # nodeName/phase into this shared pod dict — clear those so
            # failure reasons and the reported pod see the pre-bind state
            if not had_node_name[p_i]:
                (pod.get("spec") or {}).pop("nodeName", None)
                (pod.get("status") or {}).pop("phase", None)
                name = None
            else:
                name = (pod.get("spec") or {}).get("nodeName")
            if name:
                if name in oracle.node_index:
                    oracle.place_existing_pod(pod)
                # else dangling: kept in the tracker, never scheduled
                # (reference simulator.go:221-229)
            elif idx < 0:
                if len(failed) < MAX_DETAILED_REASONS or (
                    EXPLAIN.enabled and EXPLAIN.should_record(pod)
                ):
                    _, reasons, _ = oracle._find_feasible(pod)
                    reason = Oracle._failure_message(pod, reasons)
                else:
                    meta = pod.get("metadata") or {}
                    reason = (
                        f"failed to schedule pod ({meta.get('namespace', 'default')}/"
                        f"{meta.get('name', '')}): Unschedulable: "
                        f"0/{len(nodes)} nodes are available"
                    )
                failed.append(UnscheduledPod(pod=pod, reason=reason))
            else:
                local_i = int(local_of_arr[idx])
                if local_i < 0:
                    # same loud failure as the bulk path: a negative
                    # index would silently wrap to the LAST node
                    raise ConformanceError(
                        f"placement on masked-off node index {idx}"
                    )
                if (
                    EXPLAIN.enabled
                    and EXPLAIN.target is not None
                    and EXPLAIN.wants(pod)
                ):
                    EXPLAIN.capture(oracle, pod, local_i)
                if simple_class[class_of_pod[p_i]]:
                    commit_cache.commit(
                        oracle, pod, oracle.nodes[local_i], int(class_of_pod[p_i])
                    )
                else:
                    oracle._reserve_and_bind(pod, oracle.nodes[local_i])
        bulk(prev, len(pods))
    status = [NodeStatus(node=ns.node, pods=list(ns.pods)) for ns in oracle.nodes]
    return SimulateResult(unscheduled_pods=failed, node_status=status), oracle


def plan_fingerprint(cluster, apps, new_node, **flags) -> str:
    """Journal fingerprint of one planning problem: the LOADED inputs
    (cluster objects, expanded app resources, newnode spec) plus every
    flag that shapes the work. A resumed journal must describe exactly
    this problem (runtime/journal.py)."""
    from ..runtime.journal import config_fingerprint

    return config_fingerprint(
        {k: getattr(cluster, k) for k in sorted(vars(cluster))},
        [
            (
                a.name,
                {k: getattr(a.resource, k) for k in sorted(vars(a.resource))},
            )
            for a in apps
        ],
        new_node,
        flags,
    )


def probe_plan(
    cluster,
    apps,
    new_node,
    use_greed: bool = False,
    extended_resources: Optional[List[str]] = None,
    max_count: int = MAX_NUM_NEW_NODE,
    score_weights=None,
    tolerate_failures: int = 0,
    chaos_seed: int = 1,
    chaos_trials: int = 32,
    budget=None,
    journal=None,
    device=None,
) -> ApplyResult:
    """Fast capacity plan: encode the padded cluster once, start at the
    aggregate-resource lower bound, bisect over candidate counts (each
    probe = one masked scan, a pair = one batch launch), and replay the
    winning scan's placements into host state for the report — no
    second full simulation (replaces the reference's per-guess
    re-simulation loop, pkg/apply/apply.go:186-239). With
    `tolerate_failures` > 0 the plan also escalates until it is N+K
    survivable (resilience/chaos.py raise_plan_to_nplusk). `budget`
    halts the search at safe boundaries with a partial payload
    (runtime/budget); `journal` makes probes and scenario verdicts
    resumable. The scans run on `device` (None = the card)."""
    import gc

    # the plan allocates millions of short-lived dicts (pod expansion,
    # replay, report rows) but frees almost nothing mid-run — cyclic-GC
    # passes are pure overhead and wall-clock jitter at 100k pods.
    # Pause collection for the duration; one collect at the end.
    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.disable()
    try:
        return _probe_plan_inner(
            cluster, apps, new_node, use_greed, extended_resources,
            max_count, score_weights, tolerate_failures, chaos_seed,
            chaos_trials, budget, journal, device,
        )
    finally:
        clear_all_memos()
        if gc_was_enabled:
            gc.enable()
            gc.collect()


def _capacity_feasible():
    max_cpu, max_mem, max_vg = _resource_caps()

    def feasible(res) -> bool:
        # int-truncate like satisfyResourceSetting (apply.go:680-681)
        return (
            res.unscheduled == 0
            and int(res.cpu_util) <= max_cpu
            and int(res.mem_util) <= max_mem
            and int(res.vg_util) <= max_vg
        )

    return feasible, (max_cpu, max_mem, max_vg)


def _finish_plan(
    sweep, best, max_count, extended_resources, fail_message: str = ""
) -> ApplyResult:
    """Replay the winning probe into host state, re-check the caps on
    real state, and render the report — the tail shared by the
    single-spec plan and the multi-spec what-if."""
    from ..utils.trace import phase

    if best is None:
        res = sweep.probe(max_count)
        result, _ = replay_scenario(sweep, max_count, res.placements)
        message = fail_message or (
            f"{len(result.unscheduled_pods)} pod(s) cannot be scheduled "
            f"even with {max_count} new node(s)"
            if result.unscheduled_pods
            else satisfy_resource_setting(result.node_status)[1]
        )
        return ApplyResult(
            success=False, new_node_count=max_count, result=result, message=message
        )
    with phase("apply/replay"):
        result, replay_oracle = replay_scenario(sweep, best.count, best.placements)
    # authoritative host-side check of the caps on real state
    ok, reason = satisfy_resource_setting(result.node_status, oracle=replay_oracle)
    if result.unscheduled_pods or not ok:
        raise ConformanceError(
            "probe replay disagreed with scan: "
            + (reason or f"{len(result.unscheduled_pods)} unscheduled")
        )
    with phase("apply/report"):
        report_text = report(
            result.node_status, extended_resources or [], oracle=replay_oracle
        )
    return ApplyResult(
        success=True,
        new_node_count=best.count,
        result=result,
        report_text=report_text,
    )


def _probe_plan_inner(
    cluster, apps, new_node, use_greed, extended_resources,
    max_count, score_weights, tolerate_failures=0, chaos_seed=1,
    chaos_trials=32, budget=None, journal=None, device=None,
):
    from ..parallel.sweep import CapacitySweep
    from ..utils.trace import phase

    sweep = CapacitySweep(
        cluster,
        apps,
        new_node,
        max_count,
        use_greed=use_greed,
        score_weights=score_weights,
        device=device,
    )
    if journal is not None:
        sweep.attach_journal(journal)
    feasible, (max_cpu, max_mem, max_vg) = _capacity_feasible()
    with phase("apply/lower-bound"):
        start = sweep.lower_bound(max_cpu, max_mem, max_vg)
    with phase("apply/probe-search"):
        best = sweep.find_min_count(feasible, start=start, budget=budget)
    fail_message = ""
    if best is not None and tolerate_failures > 0:
        from ..resilience.chaos import raise_plan_to_nplusk

        with phase("apply/nplusk"):
            best, _chaos = raise_plan_to_nplusk(
                sweep,
                best,
                feasible,
                tolerate_failures,
                seed=chaos_seed,
                trials=chaos_trials,
                budget=budget,
                journal=journal,
            )
        if best is None:
            fail_message = (
                f"plan cannot tolerate {tolerate_failures} node failure(s) "
                f"within {max_count} new node(s)"
            )
    return _finish_plan(
        sweep, best, max_count, extended_resources, fail_message=fail_message
    )


def probe_plan_multi(
    cluster,
    apps,
    new_nodes: List[dict],
    use_greed: bool = False,
    extended_resources: Optional[List[str]] = None,
    max_count: int = MAX_NUM_NEW_NODE,
    score_weights=None,
    budget=None,
    device=None,
) -> List[ApplyResult]:
    """What-if capacity plan over MANY candidate newnode specs: every
    spec's min-count search runs in lockstep, a round launching each
    spec's probes as one batch-kernel launch and waiting on the card
    once (parallel/sweep.py find_min_count_multi). Returns one
    ApplyResult per spec, identical to what probe_plan would produce
    for it."""
    import gc

    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.disable()
    try:
        from ..parallel.sweep import CapacitySweep, find_min_count_multi
        from ..utils.trace import phase

        feasible, (max_cpu, max_mem, max_vg) = _capacity_feasible()
        jobs = []
        for new_node in new_nodes:
            sweep = CapacitySweep(
                cluster,
                apps,
                new_node,
                max_count,
                use_greed=use_greed,
                score_weights=score_weights,
                device=device,
                # expansion is spec-independent without daemonsets /
                # greed ordering: later sweeps reuse the first's pods
                share_pods_from=jobs[0][0] if jobs else None,
            )
            with phase("apply/lower-bound"):
                start = sweep.lower_bound(max_cpu, max_mem, max_vg)
            jobs.append((sweep, feasible, start))
        with phase("apply/probe-search"):
            bests = find_min_count_multi(jobs, budget=budget)

        # replay mutates pod dicts (bind writes nodeName/phase and may
        # touch annotations): sweeps that shared the first sweep's
        # expanded pods get their OWN shallow copies from the still-
        # pristine originals before ANY spec replays, so every spec's
        # ApplyResult embeds dicts no later replay rewrites
        def own_pod(p):
            q = dict(p)
            q["spec"] = dict(p["spec"])
            meta = dict(p.get("metadata") or {})
            if meta.get("annotations") is not None:
                meta["annotations"] = dict(meta["annotations"])
            q["metadata"] = meta
            if isinstance(q.get("status"), dict):
                q["status"] = dict(q["status"])
            return q

        for sweep, _, _ in jobs:
            if sweep.pods_shared:
                sweep.pods = [own_pod(p) for p in sweep.pods]
        return [
            _finish_plan(sweep, best, max_count, extended_resources)
            for (sweep, _, _), best in zip(jobs, bests)
        ]
    finally:
        clear_all_memos()
        if gc_was_enabled:
            gc.enable()
            gc.collect()


class Applier:
    def __init__(
        self,
        config: SimonConfig,
        interactive: bool = False,
        extended_resources: Optional[List[str]] = None,
        engine: str = "cuda",
        use_sweep: bool = True,
        use_greed: bool = False,
        scheduler_config: str = "",
        tolerate_node_failures: int = 0,
        chaos_seed: int = 1,
        chaos_trials: int = 32,
        journal_path: str = "",
        resume_path: str = "",
        device=None,
    ):
        if engine not in ("cuda", "oracle"):
            raise InputError(f"unknown engine {engine!r}: cuda or oracle")
        config.validate()
        self.config = config
        self.interactive = interactive
        self.extended_resources = extended_resources or []
        self.engine = engine
        self.use_sweep = use_sweep
        self.use_greed = use_greed
        self.tolerate_node_failures = tolerate_node_failures
        self.chaos_seed = chaos_seed
        self.chaos_trials = chaos_trials
        # resumable planning journal (runtime/journal.py): --journal
        # appends (creating or continuing), --resume requires the file
        # and refuses a fingerprint mismatch; resume wins when both set
        self.journal_path = journal_path
        self.resume_path = resume_path
        # the scans' device: None = the card (raises without one)
        self.device = device
        self.extenders = []
        self.score_weights = None  # None = default profile weights
        self.enable_preemption = True
        self.last_cluster = None
        if scheduler_config:
            # full KubeSchedulerConfiguration: extenders + score-plugin
            # enable/disable/weights + percentageOfNodesToScore checks
            from ..scheduler.schedconfig import load_scheduler_config

            cfg = load_scheduler_config(scheduler_config)
            self.extenders = cfg.extenders
            self.score_weights = cfg.score_weights
            self.enable_preemption = cfg.enable_preemption
            if self.extenders:
                # extenders are host RPC per pod: no batched sweep
                self.use_sweep = False

    # -- loading ------------------------------------------------------------

    def load_cluster(self) -> ResourceTypes:
        if self.config.kube_config:
            from ..models.kubeclient import create_cluster_resource_from_client

            return create_cluster_resource_from_client(self.config.kube_config)
        return cluster_from_config_dir(self.config.custom_cluster)

    def load_apps(self) -> List[AppResource]:
        out = []
        for app in self.config.app_list:
            if app.chart:
                content = process_chart(app.name, app.path)
            else:
                content = yaml_content_from_directory(app.path)
            out.append(AppResource(name=app.name, resource=decode_yaml_content(content)))
        return out

    def load_new_node(self) -> Optional[dict]:
        if not self.config.new_node:
            return None
        resources = load_directory(self.config.new_node)
        match_and_set_local_storage(resources.nodes, self.config.new_node)
        if not resources.nodes:
            return None
        return resources.nodes[0]

    # -- planning -----------------------------------------------------------

    def _simulate_with_count(
        self, cluster, apps, new_node, count, budget=None
    ) -> SimulateResult:
        padded = cluster.copy()
        if new_node is not None and count > 0:
            from ..parallel.sweep import _new_nodes

            padded.nodes = list(padded.nodes) + _new_nodes(new_node, count)
        return simulate(
            padded,
            apps,
            engine=self.engine,
            use_greed=self.use_greed,
            extenders=self.extenders,
            score_weights=self.score_weights,
            enable_preemption=self.enable_preemption,
            budget=budget,
            device=self.device,
        )

    def open_journal(self, cluster, apps, new_node):
        """Open the planning journal when configured (None otherwise),
        keyed by the fingerprint of the loaded inputs + flags."""
        if not (self.journal_path or self.resume_path):
            return None
        from ..runtime.journal import Journal

        fp = plan_fingerprint(
            cluster,
            apps,
            new_node,
            engine=self.engine,
            use_greed=self.use_greed,
            tolerate_node_failures=self.tolerate_node_failures,
            chaos_seed=self.chaos_seed,
            chaos_trials=self.chaos_trials,
        )
        if self.resume_path:
            return Journal.resume(self.resume_path, fp)
        return Journal.open(self.journal_path, fp)

    def run(self, select_apps=None, budget=None) -> ApplyResult:
        # release the identity memos' strong refs to this run's object
        # graph at exit (the serial guesses inside rely on them warm)
        try:
            return self._run_inner(select_apps, budget=budget)
        finally:
            clear_all_memos()

    def _run_inner(self, select_apps=None, budget=None) -> ApplyResult:
        from ..utils.trace import GLOBAL, phase

        # per-run phase times, not cumulative across runs in one process
        GLOBAL.reset()
        with phase("apply/load"):
            cluster = self.load_cluster()
            apps = self.load_apps()
            if select_apps is not None:
                apps = [a for a in apps if a.name in select_apps]
            new_node = self.load_new_node()
        # kept for callers that snapshot the result (cli.py: PDBs and
        # PriorityClasses ride along)
        self.last_cluster = cluster
        journal = self.open_journal(cluster, apps, new_node)
        if journal is not None and journal.replayed:
            GLOBAL.note(
                "journal-resume",
                f"{journal.replayed} record(s) replayed"
                + (f", {journal.dropped} torn record dropped" if journal.dropped else ""),
            )
        try:
            return self._plan(cluster, apps, new_node, budget, journal)
        finally:
            if journal is not None:
                journal.close()

    def _plan(self, cluster, apps, new_node, budget, journal=None) -> ApplyResult:
        from ..utils.trace import phase

        # N+K needs the batched plan path: the committed placement, the
        # outage sweep and the escalation all live on the encoded sweep
        batched_path = (
            self.use_sweep and new_node is not None and self.engine == "cuda"
        )
        if self.tolerate_node_failures > 0 and not batched_path:
            raise InputError(
                "--tolerate-node-failures requires the batched plan "
                "path: engine cuda, the sweep enabled, and a newNode "
                "spec to escalate with"
            )
        if batched_path:
            fast = self._plan_with_probes(
                cluster, apps, new_node, budget=budget, journal=journal
            )
            if fast is not None:
                return fast
            if self.tolerate_node_failures > 0:
                raise InputError(
                    "--tolerate-node-failures requires the batched plan, "
                    "but this workload takes the serial engine — "
                    "priority/extender workloads cannot ride the sweep"
                )

        start_count = 0
        if self.use_sweep and new_node is not None:
            # the sweep narrows the search; the authoritative serial run
            # below still validates its pick (incl. the VG cap the sweep
            # cannot see) and escalates further if needed
            with phase("apply/sweep"):
                hint = self._sweep_min_count(cluster, apps, new_node)
            if hint is not None:
                start_count = hint

        max_count = 0 if new_node is None else MAX_NUM_NEW_NODE
        result = None
        for count in range(start_count, max_count + 1):
            if budget is not None:
                budget.check(f"serial escalation (count {count})")
            with phase("apply/simulate"):
                result = self._simulate_with_count(
                    cluster, apps, new_node, count, budget=budget
                )
            if result.unscheduled_pods:
                continue
            ok, reason = satisfy_resource_setting(result.node_status)
            if not ok:
                continue
            with phase("apply/report"):
                report_text = report(result.node_status, self.extended_resources)
            return ApplyResult(
                success=True,
                new_node_count=count,
                result=result,
                report_text=report_text,
            )
        if result is not None and result.unscheduled_pods:
            message = (
                f"{len(result.unscheduled_pods)} pod(s) cannot be scheduled "
                f"even with {max_count} new node(s)"
            )
        else:
            _, message = (
                satisfy_resource_setting(result.node_status) if result else (False, "no result")
            )
        return ApplyResult(
            success=False, new_node_count=max_count, result=result, message=message
        )

    def _plan_with_probes(
        self, cluster, apps, new_node, budget=None, journal=None
    ) -> Optional[ApplyResult]:
        """The batched plan. Returns None only for a workload the scan
        cannot model (priority, permit or stateful plugins), which the
        serial escalation loop plans instead; every other error
        propagates."""
        from ..parallel.sweep import PrioritySignalError
        from ..utils.trace import GLOBAL

        try:
            return probe_plan(
                cluster,
                apps,
                new_node,
                use_greed=self.use_greed,
                extended_resources=self.extended_resources,
                score_weights=self.score_weights,
                tolerate_failures=self.tolerate_node_failures,
                chaos_seed=self.chaos_seed,
                chaos_trials=self.chaos_trials,
                budget=budget,
                journal=journal,
                device=self.device,
            )
        except PrioritySignalError as e:
            GLOBAL.note("apply-serial-route", str(e))
            return None

    def _sweep_min_count(self, cluster, apps, new_node) -> Optional[int]:
        """One batched sweep over all candidate counts (one batch
        launch, or the torch scan's probes for custom score plugins);
        returns the minimal count that schedules everything within the
        caps, or None for a workload the scan cannot model (priority,
        permit or stateful plugins): the serial escalation loop plans
        those, as the JAX package's Applier does."""
        from ..parallel.sweep import PrioritySignalError, sweep_node_counts
        from ..utils.trace import GLOBAL

        try:
            res = sweep_node_counts(
                cluster,
                apps,
                new_node,
                list(range(0, MAX_NUM_NEW_NODE + 1)),
                use_greed=self.use_greed,
                score_weights=self.score_weights,
                device=self.device,
            )
        except PrioritySignalError as e:
            GLOBAL.note("apply-serial-route", str(e))
            return None
        max_cpu, max_mem, _ = _resource_caps()
        for s, count in enumerate(res.counts):
            # int-truncate like satisfyResourceSetting (apply.go:680-681)
            if (
                res.unscheduled[s] == 0
                and int(res.cpu_util[s]) <= max_cpu
                and int(res.mem_util[s]) <= max_mem
            ):
                return count
        return None
