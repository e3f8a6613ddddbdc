"""Capacity-planning sweep: many candidate node counts over one encoding.

The reference's capacity loop is interactive: guess a node count, re-run
the whole simulation, ask the user (pkg/apply/apply.go:186-239). Here
every candidate count is one scenario of one encoded cluster:

- the cluster is padded with `max_count` copies of the candidate node
  spec (named `simon-%02d` with the `simon/new-node` label, mirroring
  newFakeNodes, apply.go:288-306)
- scenario s enables the first s new nodes via a node-validity mask and
  drops daemonset pods that belong to disabled nodes via a pod-activity
  mask (the reference regenerates them per run)
- a probe is one masked fused scan (ops/fused_scan.py run_fused_scan);
  two counts (`probe_pair`) or many (`probe_many`) go in ONE launch of
  the scenario-batch kernel, one cluster of blocks per scenario
- a batch the kernel does not carry (custom score plugins;
  fused_scan.torch_scan_reason names it) runs every probe on the eager
  torch scan (ops/scan.py run_scan_masked), one scenario at a time, as
  the JAX package's sweep runs it on its XLA scan (_probe_xla)

Ported from the JAX package's parallel/sweep.py with the same search
shape, plus its resumable journal (attach_journal), its multi-spec
what-if search (find_min_count_multi) and the outage-scenario rows the
chaos engine rides (serial_scenario, probe_scenarios: the batch
kernel's pins-first mode). Device work goes through runtime/guard.py:
a device OOM halves a chunk of scenarios; a single scenario that still
runs out raises on the card (on the CPU it goes to the serial oracle,
trace-noted); every other error propagates. There is
no counterpart of the reference's preload_plan_group
(ops/pallas_scan.py), which packs every spec's plan into one host-to-TPU
transfer for its relay: each plan here is built on the card by its own
sweep, with no relay between.

The device mesh (parallel/mesh.py; `CapacitySweep.mesh`, from
`current_mesh`): the layout planner splits probe_many's counts and
probe_scenarios' rows into one batch-kernel launch a mesh device
(`mesh_<site>_sweep` for the outage rows), the chunked executor told
the shard count; and a probe of a torch-scan batch takes the
node-sharded torch scan (site `mesh_scan`) when the planner picks the
node axis.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..models import workloads as wl
from ..models.decode import ResourceTypes
from ..models.validation import InputError
from ..obs.costs import COSTS
from ..obs.profile import to_host
from ..ops import fused_scan
from ..ops.fused_scan import INACTIVE
from ..runtime.guard import run_chunked
from ..scheduler.core import AppResource, _sort_app_pods
from ..scheduler.oracle import Oracle

__all__ = [
    "CapacitySweep",
    "INACTIVE",
    "PrioritySignalError",
    "ProbeResult",
    "SweepResult",
    "find_min_count_multi",
    "sweep_node_counts",
]


class PrioritySignalError(InputError):
    """Raised when a batched sweep is asked to plan a priority-bearing
    workload: the scan cannot model PrioritySort/preemption, and a
    silent non-preemptive plan would diverge from simulate() on the
    same input. Callers (apply/applier.py) route such a workload to the
    serial escalation loop, whose simulate() handles priority."""


@dataclass
class SweepResult:
    counts: List[int]
    unscheduled: np.ndarray  # [Sc] number of unschedulable (active) pods
    cpu_util: np.ndarray  # [Sc] percent
    mem_util: np.ndarray  # [Sc] percent
    placements: np.ndarray  # [Sc, P] node index / -1 / -2(inactive)
    pods: List[dict]
    node_names: List[str]
    vg_util: Optional[np.ndarray] = None  # [Sc] percent (0 when no VGs)


@dataclass
class ProbeResult:
    """One capacity scenario, evaluated by a single masked scan."""

    count: int
    unscheduled: int
    cpu_util: float
    mem_util: float
    vg_util: float
    placements: np.ndarray  # [P] node index / -1 / -2(inactive)


def _probe_to_record(res: ProbeResult) -> dict:
    """JSON-serializable journal record of one probe (runtime/journal)."""
    return {
        "count": int(res.count),
        "unscheduled": int(res.unscheduled),
        "cpuUtil": float(res.cpu_util),
        "memUtil": float(res.mem_util),
        "vgUtil": float(res.vg_util),
        "placements": [int(x) for x in np.asarray(res.placements)],
    }


def _probe_from_record(rec: dict) -> ProbeResult:
    return ProbeResult(
        count=int(rec["count"]),
        unscheduled=int(rec["unscheduled"]),
        cpu_util=float(rec["cpuUtil"]),
        mem_util=float(rec["memUtil"]),
        vg_util=float(rec["vgUtil"]),
        placements=np.asarray(rec["placements"], dtype=np.int64),
    )


def _new_nodes(spec: dict, count: int) -> List[dict]:
    out = []
    for i in range(count):
        node = wl.make_valid_node(copy.deepcopy(spec), f"{wl.NEW_NODE_NAME_PREFIX}-{i:02d}")
        node["metadata"].setdefault("labels", {})[wl.LABEL_NEW_NODE] = ""
        out.append(node)
    return out


def _daemonset_target(pod: dict) -> Optional[str]:
    """The node a daemonset pod is pinned to via its matchFields term."""
    aff = ((pod.get("spec") or {}).get("affinity") or {}).get("nodeAffinity") or {}
    required = aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in required.get("nodeSelectorTerms") or []:
        for f in term.get("matchFields") or []:
            if f.get("key") == "metadata.name" and f.get("operator") == "In":
                values = f.get("values") or []
                if values:
                    return values[0]
    return None


class CapacitySweep:
    """Encode-once / probe-many capacity search.

    The cluster is padded with `max_count` candidate nodes exactly once;
    every probe is a single masked scan with a different node-validity
    mask over the same plan (the reference re-runs the whole simulation
    per guess, pkg/apply/apply.go:186-239). The plan lives on `device`:
    the card unless the caller names another. `share_pods_from` (the
    multi-spec what-if) reuses a sibling sweep's expanded pods where the
    expansion does not depend on the spec.
    """

    def __init__(
        self,
        cluster: ResourceTypes,
        apps: List[AppResource],
        new_node_spec: Optional[dict],
        max_count: int,
        use_greed: bool = False,
        score_weights=None,
        device=None,
        share_pods_from: "Optional[CapacitySweep]" = None,
    ):
        from ..ops.encode import (
            encode_batch,
            encode_cluster,
            encode_dynamic,
            features_of_batch,
        )
        from ..utils.trace import GLOBAL, phase

        self.device = fused_scan.resolve_device(device)
        self.max_count = max_count if new_node_spec is not None else 0
        padded = cluster.copy()
        padded.nodes = list(padded.nodes) + _new_nodes(new_node_spec, self.max_count)

        # Build oracle at full padding; generate the full pod sequence
        # the serial path would see (cluster pods, then apps in order).
        # A multi-spec what-if (probe_plan_multi) reuses a sibling
        # sweep's expanded pod list when expansion is spec-INDEPENDENT:
        # the only node-dependent expansions are daemonsets (one pod per
        # node) and greed_sort ordering. The shared dicts follow the
        # same repeated-replay contract as one sweep replayed at several
        # counts (had_node_name below).
        if (
            share_pods_from is None
            or use_greed
            or padded.daemon_sets
            or any(app.resource.daemon_sets for app in apps)
            or share_pods_from.max_count != self.max_count
            or share_pods_from.n_base != len(cluster.nodes)
        ):
            share_pods_from = None
        # replays MUTATE pod dicts (bind writes nodeName/phase), so a
        # multi-spec caller gives each sweep its own copies before
        # replaying (applier.probe_plan_multi checks this flag)
        self.pods_shared = share_pods_from is not None
        with phase("sweep/expand"):
            self.oracle = Oracle(padded.nodes)
            if share_pods_from is not None:
                # expansion (and its priority/plugin checks) shared
                pods = share_pods_from.pods
            else:
                pods = self._expand(cluster, padded, apps, use_greed)
        self.pods = pods
        self.n = len(padded.nodes)
        self.n_base = self.n - self.max_count

        with phase("sweep/encode"):
            self.cluster_enc = encode_cluster(self.oracle)
            self.batch = encode_batch(self.oracle, self.cluster_enc, pods)
            self.dyn = encode_dynamic(self.oracle, self.cluster_enc)
            self.features = features_of_batch(
                self.cluster_enc, self.batch, weights=score_weights
            )
            # a batch the kernel does not carry (custom score plugins)
            # runs every probe on the torch scan; else one kernel plan
            self.scan_reason = fused_scan.torch_scan_reason(self.features)
            self.plan = (
                None
                if self.scan_reason is not None
                else fused_scan.build_plan(
                    self.cluster_enc, self.batch, self.dyn, self.features,
                    device=self.device,
                )
            )
        self._scan_inputs = None  # the torch scan's (static, init), lazily
        self._pins_plan = None  # the plan with pins on, lazily
        # the process-wide mesh (parallel/mesh.py): the layout planner
        # decides per request whether to split the scenario axis
        # (probe_many, probe_scenarios) or the node axis (a torch-scan
        # probe) across it; None = one device
        from . import mesh as mesh_mod

        self.mesh = mesh_mod.current_mesh(self.device)
        self._node_plan = None  # the node-sharded scan's state, lazily
        self._mesh_plans: dict = {}  # device -> (plan, its copy there)
        # optional resumable journal (runtime/journal.py): probe()
        # serves journaled counts without touching the device and
        # appends every fresh result (attach_journal)
        self.journal = None

        # which pods arrived with spec.nodeName, recorded BEFORE any
        # replay binds pods (replay_scenario writes nodeName into these
        # shared pod dicts; a later replay must not mistake a previous
        # replay's binding for an original pin)
        self.had_node_name = np.array(
            [bool((p.get("spec") or {}).get("nodeName")) for p in pods], dtype=bool
        )
        # daemonset pods of disabled candidate nodes are inactive in
        # that scenario (the reference regenerates them per run)
        self._ds_target = np.full(len(pods), -1, dtype=np.int64)
        name_to_idx = self.oracle.node_index
        for p_i, pod in enumerate(pods):
            target = _daemonset_target(pod)
            if target is not None and target in name_to_idx:
                self._ds_target[p_i] = name_to_idx[target]
        GLOBAL.note(
            "sweep-kernel",
            fused_scan.kernel_label(self.plan)
            if self.plan is not None
            else f"torch-scan ({self.scan_reason})",
        )

    def _expand(self, cluster, padded, apps, use_greed) -> List[dict]:
        """The full pod sequence the serial path would see, with the
        checks that route a workload to the serial engine."""
        pods: List[dict] = []
        pods.extend(wl.pods_excluding_daemon_sets(padded))
        for ds in padded.daemon_sets:
            pods.extend(wl.pods_from_daemon_set(ds, padded.nodes))
        for app in apps:
            app_pods = wl.generate_valid_pods_from_app(app.name, app.resource, padded.nodes)
            if use_greed:
                # same ordering the authoritative serial run will use
                # (scheduler/core.py schedule_app): greed_sort ignores
                # simon new nodes, so max-count padding and the
                # per-count serial cluster sort pods identically
                from ..scheduler.queues import greed_sort

                app_pods = greed_sort(padded.nodes, app_pods)
            pods.extend(_sort_app_pods(app_pods))
        from ..scheduler.preemption import build_priority_resolver, pod_uses_priority

        resolver = build_priority_resolver(cluster.priority_classes)
        if any(pod_uses_priority(p, resolver) for p in pods):
            raise PrioritySignalError(
                "workload carries priority/priorityClassName; the "
                "batched scan has no priority/preemption semantics — "
                "use the serial engine"
            )
        if self.oracle.registry.needs_serial:
            raise PrioritySignalError(
                "a registered plugin defines permit() or a stateful "
                "hook (reserve/prebind); the batched scan cannot "
                "honor per-pod host callbacks — use the serial engine"
            )
        return pods

    # -- masks -------------------------------------------------------------

    def node_valid(self, count: int) -> np.ndarray:
        valid = np.ones(self.n, dtype=bool)
        valid[self.n_base + count :] = False
        return valid

    def pod_active(self, valid: np.ndarray) -> np.ndarray:
        active = np.ones(len(self.pods), dtype=bool)
        tgt = self._ds_target
        has_tgt = tgt >= 0
        active[has_tgt] = valid[tgt[has_tgt]]
        return active

    # -- probes ------------------------------------------------------------

    def attach_journal(self, journal):
        """Serve journaled probes without device work; append fresh
        ones (runtime/journal.py, `--journal` / `--resume`)."""
        self.journal = journal

    def _scenario(self, count: int):
        valid = self.node_valid(count)
        return self.pod_active(valid), valid, self.batch.pinned_node

    def _stats(self, valid, placements, used_c, used_m, vg_used):
        """Unscheduled count and utilization of one scan, on the host
        (the JAX package's _pallas_result arithmetic). `vg_used` is
        [N, V]."""
        v = np.asarray(valid)[: self.n]
        denom_c = max(int(np.asarray(self.cluster_enc.alloc_mcpu)[v].sum()), 1)
        denom_m = max(int(np.asarray(self.cluster_enc.alloc_mem)[v].sum()), 1)
        denom_vg = max(int(np.asarray(self.cluster_enc.vg_cap)[v].sum()), 1)
        return (
            int((placements == -1).sum()),
            100.0 * float(used_c[v].sum()) / denom_c,
            100.0 * float(used_m[v].sum()) / denom_m,
            100.0 * float(vg_used[v].sum()) / denom_vg,
        )

    def _result(self, count, valid, placements, final) -> ProbeResult:
        """ProbeResult of one kernel scan."""
        placements = to_host(placements).astype(np.int64)
        # the scan's final VG usage ([V, N]); a plan without the storage
        # block never grows it, so there the init is final
        vg_used = (to_host(final["vg_used"]).T if "vg_used" in final
                   else np.asarray(self.dyn.vg_used))
        unsched, cpu, mem, vg = self._stats(
            valid, placements, to_host(final["used_mcpu"]), to_host(final["used_mem"]),
            vg_used)
        return ProbeResult(count=count, unscheduled=unsched, cpu_util=cpu,
                           mem_util=mem, vg_util=vg, placements=placements)

    def _scan_static_state(self):
        """The torch scan's (ScanStatic, ScanState) on the sweep's
        device, built once."""
        if self._scan_inputs is None:
            from ..ops.encode import to_scan_state, to_scan_static

            self._scan_inputs = (
                to_scan_static(self.cluster_enc, self.batch, device=self.device),
                to_scan_state(self.dyn, self.batch, device=self.device),
            )
        return self._scan_inputs

    def _torch_scan(self, valid, active, pinned, pins_first: bool = False,
                    site: str = "sweep_probe"):
        """One scenario on the torch scan (ops/scan.py run_scan_masked):
        the capacity probe's single pass, or with `pins_first` the
        reference's two chained passes (_scenario_pinned_impl): every
        pinned pod commits, then every free pod schedules; each pass one
        dispatch at `site`. Returns (placements [P] int64 numpy,
        unscheduled, cpu, mem, vg)."""
        from ..ops import scan as scan_ops

        static, init = self._scan_static_state()
        cls = self.batch.class_of_pod
        valid = np.asarray(valid, dtype=bool)
        active = np.asarray(active, dtype=bool)
        pinned = np.asarray(pinned, dtype=np.int64)
        if pins_first:
            features = self.features._replace(pins=True)
            p1, state1 = scan_ops.run_scan_masked(
                static, init, cls, pinned, valid, active & (pinned >= 0), features=features,
                site=site)
            p2, final = scan_ops.run_scan_masked(
                static, state1, cls, pinned, valid, active & (pinned < 0), features=features,
                site=site)
            placements = np.where(pinned >= 0, to_host(p1), to_host(p2))
        else:
            placements, final = scan_ops.run_scan_masked(
                static, init, cls, pinned, valid, active, features=self.features, site=site)
            placements = to_host(placements)
        placements = placements.astype(np.int64)
        return (placements, *self._stats(
            valid, placements, to_host(final.used_mcpu), to_host(final.used_mem),
            to_host(final.vg_used)))

    def probe(self, count: int) -> ProbeResult:
        """Evaluate one candidate count: one masked scan (the
        `fused_scan_base` / `fused_scan_ext` kernel on a CUDA plan, the
        torch scan for a batch the kernel does not carry); any error,
        a device OOM too, propagates. Counts already in the attached
        journal never touch the device."""
        if self.journal is not None:
            cached = self.journal.get_probe(count)
            if cached is not None:
                return _probe_from_record(cached)
        if self.plan is not None:
            res = self._probe_kernel(count)
        else:
            from . import mesh as mesh_mod

            valid = self.node_valid(count)
            # the node axis: ONE scenario over a cluster the planner
            # says is too big (or predicted not to fit) on one device
            layout = mesh_mod.plan_layout(
                "sweep_probe", mesh=self.mesh, n_scenarios=1, n_nodes=self.n,
                sample=bool(getattr(self.features, "sample", False)))
            if layout.axis == "node":
                res = self._probe_mesh(count, valid)
            else:
                res = self._probe_torch_scan(count, valid)
        if self.journal is not None:
            self.journal.record_probe(_probe_to_record(res))
        return res

    def _probe_mesh(self, count: int, valid) -> ProbeResult:
        """One capacity probe on the node-sharded torch scan: the padded,
        split state is built once a sweep (NodeShardPlan)."""
        from ..utils.trace import profiled
        from . import mesh as mesh_mod

        if self._node_plan is None:
            static, init = self._scan_static_state()
            self._node_plan = mesh_mod.NodeShardPlan(
                self.mesh, static, init, self.batch.class_of_pod, self.batch.pinned_node,
                self.features)
        with profiled("sweep/probe"):
            pl, unsched, cpu, mem, vg = self._node_plan.run(valid, self.pod_active(valid))
        return ProbeResult(count=count, unscheduled=unsched, cpu_util=cpu,
                           mem_util=mem, vg_util=vg, placements=pl)

    def _probe_kernel(self, count: int) -> ProbeResult:
        from ..utils.trace import profiled

        active, valid, pinned = self._scenario(count)
        with profiled("sweep/probe"):
            placements, final = fused_scan.run_fused_scan(
                self.plan, self.batch.class_of_pod, active, valid, pinned=pinned,
                site="sweep_probe")
            return self._result(count, valid, placements, final)

    def _probe_torch_scan(self, count: int, valid) -> ProbeResult:
        from ..utils.trace import profiled

        with profiled("sweep/probe"):
            pl, unsched, cpu, mem, vg = self._torch_scan(
                valid, self.pod_active(valid), self.batch.pinned_node)
        return ProbeResult(count=count, unscheduled=unsched, cpu_util=cpu,
                           mem_util=mem, vg_util=vg, placements=pl)

    def _serial_floor(self, fn):
        """`fn`, the chunked executor's serial floor, where the sweep's
        work is on the CPU; None on the card, where a single scenario
        that still runs out of device memory raises DeviceOOM rather
        than move to the host."""
        return fn if self.device.type == "cpu" else None

    def _probe_serial(self, count: int, valid) -> ProbeResult:
        """The serial floor: the deterministic host oracle, no device."""
        placements, _reasons = self.serial_scenario(valid, self.pod_active(valid))
        pl, unsched, cpu, mem, vg = self._host_scenario_stats(valid, placements)
        return ProbeResult(count=count, unscheduled=int(unsched), cpu_util=float(cpu),
                           mem_util=float(mem), vg_util=float(vg), placements=pl)

    def launch_counts(self, counts: List[int]):
        """Launch several counts in ONE batch-kernel launch (one cluster
        of blocks a count) without waiting for it: the device rows, for
        results_of. Needs a kernel plan."""
        scenarios = [self._scenario(c) for c in counts]
        return fused_scan.run_fused_scan_batch(self.plan, self.batch.class_of_pod, scenarios,
                                               site="sweep_many")

    def launch_counts_on(self, mesh, counts: List[int]):
        """launch_counts split over `mesh`: one batch-kernel launch a
        mesh device over its share of the counts, rows in count order."""
        from . import mesh as mesh_mod

        return [row for _p, _lo, _hi, outs in mesh_mod.launch_rows(
            mesh, self.plan, self.batch.class_of_pod, [self._scenario(c) for c in counts],
            site="sweep_many", plans=self._mesh_plans) for row in outs]

    def results_of(self, counts: List[int], rows) -> List[ProbeResult]:
        """ProbeResults of launch_counts' rows (the first read waits for
        the launch)."""
        return [self._result(c, self.node_valid(c), placements, final)
                for c, (placements, final) in zip(counts, rows)]

    def probe_counts(self, counts: List[int], mesh=None) -> List[ProbeResult]:
        """Evaluate several counts: in ONE launch of the scenario-batch
        kernel (`fused_scan_batch`, one cluster of blocks per count), or
        with `mesh` one launch a mesh device, through the chunked
        executor (a device OOM halves the batch, and a single count that
        still runs out raises on the card); on the torch scan one probe
        after another. Journaled counts are served from the journal and
        fresh ones recorded."""
        from ..utils.trace import profiled

        counts = list(counts)
        if self.plan is None or (
            self.journal is not None
            and any(self.journal.get_probe(c) is not None for c in counts)
        ):
            # journaled counts must not ride the batch: probe() serves
            # them from the journal, so batching would re-run them
            return [self.probe(c) for c in counts]

        def evaluate(lo, hi):
            rows = (self.launch_counts(counts[lo:hi]) if mesh is None
                    else self.launch_counts_on(mesh, counts[lo:hi]))
            return self.results_of(counts[lo:hi], rows)

        shards = mesh.size if mesh is not None else 1
        with profiled("sweep/probe"):
            out = run_chunked(
                evaluate, len(counts), label="sweep",
                serial_fallback=self._serial_floor(lambda i: self._probe_serial(
                    counts[i], self.node_valid(counts[i]))),
                estimate=COSTS.chunk_estimator("sweep_many", self.plan, len(self.pods),
                                               shards=shards),
                shards=shards,
            )
        if self.journal is not None:
            for r in out:
                self.journal.record_probe(_probe_to_record(r))
        return out

    def probe_pair(self, c1: int, c2: int):
        """Two candidate counts in one batch launch."""
        r1, r2 = self.probe_counts([c1, c2])
        return r1, r2

    def probe_many(self, counts: List[int], mesh=None) -> SweepResult:
        """Evaluate many counts in one batch launch, or split over a
        mesh: an explicit `mesh` wins (sweep_node_counts(mesh=));
        otherwise the sweep's mesh when the layout planner picks the
        scenario axis."""
        if mesh is None and self.plan is not None:
            from . import mesh as mesh_mod

            layout = mesh_mod.plan_layout(
                "sweep_many", mesh=self.mesh, n_scenarios=len(counts), n_nodes=self.n,
                sample=bool(getattr(self.features, "sample", False)))
            if layout.axis == "scenario":
                mesh = self.mesh
        res = self.probe_counts(list(counts), mesh=mesh)
        return SweepResult(
            counts=list(counts),
            unscheduled=np.array([r.unscheduled for r in res], dtype=np.int64),
            cpu_util=np.array([r.cpu_util for r in res]),
            mem_util=np.array([r.mem_util for r in res]),
            placements=np.stack([r.placements for r in res]),
            pods=self.pods,
            node_names=[ns.name for ns in self.oracle.nodes],
            vg_util=np.array([r.vg_util for r in res]),
        )

    # -- serial (host-oracle) scenario evaluation ---------------------------

    def serial_scenario(self, valid, active, pinned=None, pins_first=False):
        """Deterministic host-side evaluation of ONE masked scenario
        through the serial oracle (scheduler/oracle.py) — the chaos
        engine's independent confirmation (an N+K verdict is only
        trusted after one sampled outage re-simulates serially to the
        same answer), and on the CPU the chunked executor's floor when
        even a single scenario runs out of memory.

        `pinned[p]` >= 0 force-binds the pod to that sweep node index
        (committed placements / original spec.nodeName); -1 schedules
        through the full filter+score cycle. Defaults to the batch's
        original pins. `pins_first` commits every pinned pod before any
        free pod schedules (the chaos model's two passes); the default
        interleaves in pod order like the capacity scan. Returns
        (placements[P] in SWEEP node indices with the scan's -1/-2
        conventions, {pod_index: reason} for unscheduled pods)."""
        if pinned is None:
            pinned = np.asarray(self.batch.pinned_node)
        valid = np.asarray(valid)
        active = np.asarray(active)
        kept = [i for i in range(self.n) if valid[i]]
        oracle = Oracle(
            [self.oracle.nodes[i].node for i in kept],
            score_weights=self.features.weights,
        )
        local_of = {sweep_i: local_i for local_i, sweep_i in enumerate(kept)}
        sweep_index = self.oracle.node_index
        placements = np.full(len(self.pods), -1, dtype=np.int64)
        reasons: dict = {}

        def handle(p_i, pod, pins_only):
            if not active[p_i]:
                placements[p_i] = INACTIVE
                return
            pin = int(pinned[p_i])
            if pins_only is not None and pins_only != (pin >= 0):
                return
            # repeated-replay contract (replay_scenario): a previous
            # replay may have bound this shared dict — only original
            # spec.nodeName pins survive into this scenario
            if not self.had_node_name[p_i]:
                (pod.get("spec") or {}).pop("nodeName", None)
                (pod.get("status") or {}).pop("phase", None)
            if pin >= 0:
                if not valid[pin]:
                    # pinned to a masked-out node: does not exist in
                    # this scenario (scan INACTIVE convention)
                    placements[p_i] = INACTIVE
                    return
                if self.had_node_name[p_i]:
                    # original spec.nodeName: admit exactly like the
                    # replay (GPU-index annotations honored)
                    oracle.place_existing_pod(pod)
                else:
                    oracle._reserve_and_bind(pod, oracle.nodes[local_of[pin]])
                placements[p_i] = pin
                return
            name, reason = oracle.schedule_pod(pod)
            if name is None:
                placements[p_i] = -1
                reasons[p_i] = reason
            else:
                placements[p_i] = sweep_index[name]

        if pins_first:
            for p_i, pod in enumerate(self.pods):
                handle(p_i, pod, pins_only=True)
            for p_i, pod in enumerate(self.pods):
                if active[p_i] and int(pinned[p_i]) < 0:
                    handle(p_i, pod, pins_only=False)
        else:
            for p_i, pod in enumerate(self.pods):
                handle(p_i, pod, pins_only=None)
        return placements, reasons

    def _host_scenario_stats(self, valid, placements):
        """The (placements, unscheduled, cpu/mem/vg utilization) tuple
        of a scan, recomputed on the host from serial placements — same
        arithmetic, aggregate form (committed requests add onto the
        encoded base usage; placements only land on valid nodes)."""
        b, d, c_enc = self.batch, self.dyn, self.cluster_enc
        v = np.asarray(valid)
        placed = np.asarray(placements) >= 0
        cls = np.asarray(b.class_of_pod)[placed]
        used_c = int(d.used_mcpu[v].sum()) + int(b.req_mcpu[cls].sum())
        used_m = int(d.used_mem[v].sum()) + int(b.req_mem[cls].sum())
        used_v = int(d.vg_used[v].sum()) + int(b.lvm_sizes[cls].sum())
        denom_c = max(int(c_enc.alloc_mcpu[v].sum()), 1)
        denom_m = max(int(c_enc.alloc_mem[v].sum()), 1)
        denom_v = max(int(c_enc.vg_cap[v].sum()), 1)
        return (
            np.asarray(placements),
            np.int64((np.asarray(placements) == -1).sum()),
            np.float64(100.0 * used_c / denom_c),
            np.float64(100.0 * used_m / denom_m),
            np.float64(100.0 * used_v / denom_v),
        )

    def _plan_with_pins(self) -> "fused_scan.FusedPlan":
        """The kernel plan with pins on (the same tensors): the outage
        rows pin survivors even when the batch itself carries no pin."""
        if self._pins_plan is None:
            import dataclasses

            self._pins_plan = dataclasses.replace(self.plan, has_pins=True)
        return self._pins_plan

    def _kernel_rows(self, pod_active, node_valid, pinned, pins_first: bool, site: str,
                     mesh=None):
        """One batch launch over the rows at `site`, or with `mesh` one
        launch a mesh device over its share; their (placements,
        unscheduled, cpu, mem, vg) tuples, reduced on each launch's
        device and read back once a launch."""
        scenarios = list(zip(pod_active, node_valid, pinned))
        if mesh is None:
            shares = [(self._plan_with_pins(), 0, len(scenarios), fused_scan.run_fused_scan_batch(
                self._plan_with_pins(), self.batch.class_of_pod, scenarios,
                pins_first=pins_first, site=site))]
        else:
            from . import mesh as mesh_mod

            shares = mesh_mod.launch_rows(mesh, self._plan_with_pins(), self.batch.class_of_pod,
                                          scenarios, site=site, pins_first=pins_first,
                                          plans=self._mesh_plans)
        out = []
        for plan, lo, hi, rows in shares:
            out.extend(self._row_stats(plan, rows, node_valid[lo:hi]))
        return out

    def _row_stats(self, plan, rows, node_valid):
        """The (placements, unscheduled, cpu, mem, vg) tuples of one
        launch's rows, reduced on its plan's device."""
        import torch

        dev = plan.device
        valid_t = torch.from_numpy(np.ascontiguousarray(node_valid)).to(dev)
        alloc = plan.alloc
        placements = torch.stack([r[0] for r in rows]).long()
        used_c = torch.stack([r[1]["used_mcpu"] for r in rows])
        used_m = torch.stack([r[1]["used_mem"] for r in rows])
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        sums = [torch.where(valid_t, used_c, zero).sum(1),
                torch.where(valid_t, used_m, zero).sum(1),
                torch.where(valid_t, alloc[0], zero).sum(1),
                torch.where(valid_t, alloc[1], zero).sum(1),
                (placements == -1).sum(1)]
        if "vg_used" in rows[0][1]:
            vg_used = torch.stack([r[1]["vg_used"].sum(0) for r in rows])
            sums.append(torch.where(valid_t, vg_used, zero).sum(1))
        host = [to_host(t) for t in [placements] + sums]
        placements, uc, um, ac, am, unsched = host[:6]
        if len(host) > 6:
            uv = host[6]
        else:
            base = np.asarray(self.dyn.vg_used).sum(axis=1)
            uv = np.array([int(base[v].sum()) for v in node_valid], dtype=np.int64)
        vg_cap = np.asarray(self.cluster_enc.vg_cap).sum(axis=1)
        out = []
        for k, v in enumerate(node_valid):
            out.append((
                placements[k],
                int(unsched[k]),
                100.0 * float(uc[k]) / max(int(ac[k]), 1),
                100.0 * float(um[k]) / max(int(am[k]), 1),
                100.0 * float(uv[k]) / max(int(vg_cap[v].sum()), 1),
            ))
        return out

    def probe_scenarios(self, node_valid, pod_active, pinned, budget=None,
                        site: str = "chaos"):
        """Batched masked scans with PER-SCENARIO pin vectors: the
        fault-injection substrate (resilience/chaos.py). Each row of
        `node_valid` [Sc, N] / `pod_active` [Sc, P] / `pinned` [Sc, P]
        is one scenario, evaluated pins first: every pinned pod commits,
        then every free pod schedules (the reference's two chained
        scans, _scenario_pinned_impl). On a kernel plan a chunk of rows
        is ONE launch of the batch kernel's pins-first mode, through the
        chunked executor (a device OOM halves the chunk; a single row
        that still runs out raises on the card and goes to the serial
        oracle on the CPU); a batch the
        kernel does not carry runs the two passes on the torch scan, row
        by row, trace-noted `<site>-kernel`. Returns (placements
        [Sc, P], unscheduled [Sc], cpu_util [Sc], mem_util [Sc],
        vg_util [Sc]) as numpy arrays."""
        from ..utils.trace import GLOBAL

        node_valid = np.asarray(node_valid, dtype=bool)
        pod_active = np.asarray(pod_active, dtype=bool)
        pinned = np.asarray(pinned, dtype=np.int64)
        sc = node_valid.shape[0]
        launch_site = f"{site}_sweep"
        estimate = None
        shards = 1
        if self.plan is not None:
            from . import mesh as mesh_mod

            # the scenario axis: outage rows are independent, so a mesh
            # splits them into one launch a device at mesh_<site>_sweep
            layout = mesh_mod.plan_layout(launch_site, mesh=self.mesh, n_scenarios=sc,
                                          n_nodes=self.n)
            mesh = self.mesh if layout.axis == "scenario" else None
            shards = mesh.size if mesh is not None else 1
            GLOBAL.note(f"{site}-kernel", f"{fused_scan.PINS_FIRST_KERNEL_NAME} "
                        f"({self.plan.device.type})")
            estimate = COSTS.chunk_estimator(launch_site, self._plan_with_pins(),
                                             len(self.pods), shards=shards)

            def evaluate(lo, hi):
                return self._kernel_rows(pod_active[lo:hi], node_valid[lo:hi],
                                         pinned[lo:hi], pins_first=True,
                                         site=f"mesh_{launch_site}" if mesh else launch_site,
                                         mesh=mesh)
        else:
            GLOBAL.note(f"{site}-kernel", f"torch-scan ({self.scan_reason})")

            def evaluate(lo, hi):
                return [self._torch_scan(node_valid[i], pod_active[i], pinned[i],
                                         pins_first=True, site=launch_site)
                        for i in range(lo, hi)]

        def serial_fallback(i):
            placements, _ = self.serial_scenario(
                node_valid[i], pod_active[i], pinned[i], pins_first=True
            )
            return self._host_scenario_stats(node_valid[i], placements)

        rows = run_chunked(evaluate, sc, label=site,
                           serial_fallback=self._serial_floor(serial_fallback), budget=budget,
                           estimate=estimate, shards=shards)
        placements = np.stack([np.asarray(r[0]) for r in rows])
        unsched = np.array([int(r[1]) for r in rows], dtype=np.int64)
        cpu = np.array([float(r[2]) for r in rows])
        mem = np.array([float(r[3]) for r in rows])
        vg = np.array([float(r[4]) for r in rows])
        return placements, unsched, cpu, mem, vg

    # -- resource lower bound ----------------------------------------------

    def lower_bound(self, max_cpu: int = 100, max_mem: int = 100, max_vg: int = 100) -> int:
        """Smallest count not ruled out by aggregate resource totals and
        utilization caps. Any count below it either leaves pods
        unschedulable (sum of requests exceeds sum of allocatable) or
        violates a cap, so the scheduling search can start here. Purely
        arithmetic — no scan."""
        b, c_enc, d = self.batch, self.cluster_enc, self.dyn
        cls = b.class_of_pod
        req = {
            "mcpu": b.req_mcpu[cls].astype(np.int64),
            "mem": b.req_mem[cls].astype(np.int64),
            "eph": b.req_eph[cls].astype(np.int64),
            "pods": np.ones(len(self.pods), dtype=np.int64),
            "vg": b.lvm_sizes[cls].sum(axis=1).astype(np.int64),
        }
        alloc = {
            "mcpu": c_enc.alloc_mcpu,
            "mem": c_enc.alloc_mem,
            "eph": c_enc.alloc_eph,
            "pods": c_enc.alloc_pods,
            "vg": c_enc.vg_cap.sum(axis=1),
        }
        base_used = {
            "mcpu": int(d.used_mcpu.sum()),
            "mem": int(d.used_mem.sum()),
            "eph": int(d.used_eph.sum()),
            "pods": int(d.pod_cnt.sum()),
            "vg": int(d.vg_used.sum()),
        }
        for count in range(0, self.max_count + 1):
            valid = self.node_valid(count)
            active = self.pod_active(valid)
            ok = True
            for r in ("mcpu", "mem", "eph", "pods"):
                if base_used[r] + int(req[r][active].sum()) > int(alloc[r][valid].sum()):
                    ok = False
                    break
            if ok:
                for r, cap in (("mcpu", max_cpu), ("mem", max_mem), ("vg", max_vg)):
                    total_alloc = int(alloc[r][valid].sum())
                    if total_alloc == 0:
                        continue
                    used = base_used[r] + int(req[r][active].sum())
                    if int(used / total_alloc * 100) > cap:
                        ok = False
                        break
            if ok:
                return count
        return self.max_count

    # -- minimal-count search ----------------------------------------------

    def estimate_extra(self, res: ProbeResult) -> int:
        """How many more candidate nodes the unscheduled pods of this
        probe need by aggregate request (a Newton-style step for the
        escalation: usually lands within a node or two of the true
        minimum even when taints/selectors make the global lower bound
        loose)."""
        mask = res.placements == -1
        if not mask.any() or self.max_count == 0:
            return 1
        cls = self.batch.class_of_pod[np.asarray(mask)]
        b = self.batch
        new_i = self.n_base  # all candidate nodes share the spec
        extra = 1
        for req_v, alloc_v in (
            (b.req_mcpu[cls], self.cluster_enc.alloc_mcpu[new_i]),
            (b.req_mem[cls], self.cluster_enc.alloc_mem[new_i]),
            (b.req_eph[cls], self.cluster_enc.alloc_eph[new_i]),
            (np.ones(len(cls), dtype=np.int64), self.cluster_enc.alloc_pods[new_i]),
        ):
            need = int(req_v.sum())
            alloc = int(alloc_v)
            if alloc > 0 and need > 0:
                extra = max(extra, -(-need // alloc))
        return extra

    def _search_gen(self, feasible, start: int = 0, widen: bool = False):
        """The min-count search as a COROUTINE: yields lists of counts
        to probe, receives {count: ProbeResult}, and returns the best
        result (or None) via StopIteration. Keeping the control flow
        apart from the probe transport lets find_min_count fulfil one
        spec's requests while find_min_count_multi batches the requests
        of MANY specs into one round.

        Search shape (the JAX package's): probe `start`; on failure
        escalate by the unscheduled-request estimate (with a doubling
        backstop) — on a kernel plan asking for (hi-1, hi) together in
        one batch launch, since the estimate usually lands exactly —
        then bisect the bracket, confirming hi-1 first; with `widen` (the
        multi-spec search) a bracket of at most 16 probes every interior
        count in one round. The torch-scan route asks for one count at a
        time, as the reference's XLA route does. Monotonicity (more
        nodes never schedule fewer pods) is what makes the bisection
        sound."""
        probes: dict = {}

        probes.update((yield [start]))
        res = probes[start]
        if feasible(res):
            return res
        # grow bracket: (lo known-infeasible, hi candidate]
        lo, escalations = start, 0
        while True:
            step = max(self.estimate_extra(probes[lo]), 1 << escalations)
            hi = min(lo + step, self.max_count)
            if (
                hi - lo > 1
                and hi not in probes
                and hi - 1 not in probes
                and self.plan is not None
            ):
                # hi-1 is usually the bisection's very next question:
                # ask for both in one round
                probes.update((yield [hi - 1, hi]))
            elif hi not in probes:
                probes.update((yield [hi]))
            res = probes[hi]
            if feasible(res):
                break
            lo = hi
            if hi == self.max_count:
                return None  # infeasible even at max
            escalations += 1
        # bisect (lo infeasible, hi feasible]
        best = res
        lo_b, hi_b = lo, best.count
        if widen and 2 < hi_b - lo_b <= 16 and self.plan is not None:
            need = [c for c in range(lo_b + 1, hi_b) if c not in probes]
            if need:
                probes.update((yield need))
            for c in range(lo_b + 1, hi_b):
                if feasible(probes[c]):
                    return probes[c]
            return best
        if hi_b - lo_b > 1:
            c = hi_b - 1
            if c not in probes:
                probes.update((yield [c]))
            res = probes[c]
            if feasible(res):
                best, hi_b = res, c
            else:
                lo_b = c
        while hi_b - lo_b > 1:
            mid = (lo_b + hi_b) // 2
            if mid not in probes:
                probes.update((yield [mid]))
            res = probes[mid]
            if feasible(res):
                best, hi_b = res, mid
            else:
                lo_b = mid
        return best

    def _fulfill(self, req: List[int], on_probe=None) -> dict:
        """Probe the requested counts — two in one batch launch on a
        kernel plan."""
        if len(req) == 2 and self.plan is not None:
            r1, r2 = self.probe_pair(req[0], req[1])
            out = {r1.count: r1, r2.count: r2}
        else:
            out = {c: self.probe(c) for c in req}
        if on_probe is not None:
            for r in out.values():
                on_probe(r)
        return out

    def find_min_count(
        self,
        feasible,
        start: int = 0,
        on_probe=None,
        budget=None,
    ) -> Optional[ProbeResult]:
        """Smallest count whose probe satisfies `feasible(ProbeResult)`
        (see _search_gen for the search shape). `budget` is checked
        between probe rounds (the search's safe boundary); on halt the
        raised ExecutionHalted carries a machine-readable partial
        payload: every completed probe and the best feasible count seen
        so far."""
        from ..runtime.errors import ExecutionHalted

        gen = self._search_gen(feasible, start)
        fulfilled: dict = {}
        try:
            req = next(gen)
            while True:
                if budget is not None:
                    try:
                        budget.check("capacity-probe boundary")
                    except ExecutionHalted as e:
                        e.partial = _search_partial(fulfilled, feasible)
                        raise
                got = self._fulfill(req, on_probe)
                fulfilled.update(got)
                req = gen.send(got)
        except StopIteration as stop:
            return stop.value


def _search_partial(fulfilled: dict, feasible) -> dict:
    """Machine-readable progress of an interrupted min-count search:
    completed probes + the best (smallest) feasible count so far."""
    rows = []
    best = None
    for count in sorted(fulfilled):
        res = fulfilled[count]
        ok = bool(feasible(res))
        rows.append(
            {
                "count": int(count),
                "unscheduled": int(res.unscheduled),
                "feasible": ok,
            }
        )
        if ok and (best is None or count < best):
            best = int(count)
    return {
        "phase": "capacity-search",
        "completedProbes": rows,
        "bestCount": best,
    }


def find_min_count_multi(jobs, on_probe=None, budget=None) -> List[Optional[ProbeResult]]:
    """Drive MANY specs' min-count searches in lockstep: `jobs` is a
    list of (CapacitySweep, feasible, start). Each round collects every
    live spec's requested counts, launches them as ONE batch-kernel
    launch a spec (all specs' launches enqueued on the stream before any
    result is read), then reads the round's results, so the host waits
    on the card once a round. A spec on the torch scan probes its counts
    one by one inside the round.

    The reference's preload_plan_group (ops/pallas_scan.py) packs every
    spec's plan into one host-to-TPU transfer before round 1, for its
    relay; here each plan was built on the card where its sweep was
    made, so nothing is packed. Replaces the reference's per-guess
    re-simulation loop (pkg/apply/apply.go:186-239) across candidate
    node SPECS, not just counts."""
    import time

    from ..utils.trace import GLOBAL, phase

    gens = []
    pending: List[Optional[List[int]]] = []
    results: List[Optional[ProbeResult]] = []
    for sweep, feasible, start in jobs:
        g = sweep._search_gen(feasible, start, widen=True)
        gens.append(g)
        results.append(None)
        pending.append(next(g))
    live = list(range(len(jobs)))
    rounds = launches = 0
    round_log = []
    while live:
        if budget is not None:
            budget.check("what-if probe round")
        t0 = time.perf_counter()
        n0 = launches
        rounds += 1
        answers: List[dict] = [dict() for _ in jobs]
        with phase("sweep/probe-multi"):
            launched = []
            for i in live:
                sweep = jobs[i][0]
                if sweep.plan is None:
                    answers[i].update((c, sweep.probe(c)) for c in pending[i])
                    continue
                launched.append((i, sweep.launch_counts(pending[i])))
                launches += 1
            # the round's one wait: the first read of a result
            for i, rows in launched:
                for r in jobs[i][0].results_of(pending[i], rows):
                    answers[i][r.count] = r
        nxt = []
        for i in live:
            if on_probe is not None:
                for r in answers[i].values():
                    on_probe(r)
            try:
                pending[i] = gens[i].send(answers[i])
                nxt.append(i)
            except StopIteration as stop:
                results[i] = stop.value
                pending[i] = None
        live = nxt
        round_log.append(f"{launches - n0}l/{time.perf_counter() - t0:.3f}s")
    GLOBAL.note("whatif-rounds", rounds)
    GLOBAL.note("whatif-launches", launches)
    GLOBAL.note("whatif-round-log", ",".join(round_log))
    return results


def sweep_node_counts(
    cluster: ResourceTypes,
    apps: List[AppResource],
    new_node_spec: Optional[dict],
    counts: List[int],
    mesh=None,
    use_greed: bool = False,
    score_weights=None,
    device=None,
) -> SweepResult:
    """Evaluate `counts` candidate new-node counts in one batch launch,
    or with `mesh` one launch a mesh device."""
    max_count = max(counts) if new_node_spec is not None else 0
    sweep = CapacitySweep(
        cluster,
        apps,
        new_node_spec,
        max_count,
        use_greed=use_greed,
        score_weights=score_weights,
        device=device,
    )
    return sweep.probe_many(counts, mesh=mesh)
