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
  the scenario-batch kernel, one block per scenario

Ported from the JAX package's parallel/sweep.py with the same search
shape. There is no engine ladder: on a CUDA plan each probe launches
the kernel or raises, on a CPU plan it takes the kernel's plain
version. The mesh rungs, the resumable journal, the multi-spec what-if
search and the serial/chaos scenario rows are not ported yet
(ROADMAP.md A1).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..models import workloads as wl
from ..models.decode import ResourceTypes
from ..models.validation import InputError
from ..ops import fused_scan
from ..ops.fused_scan import INACTIVE
from ..scheduler.core import AppResource, _sort_app_pods
from ..scheduler.oracle import Oracle

__all__ = [
    "CapacitySweep",
    "INACTIVE",
    "PrioritySignalError",
    "ProbeResult",
    "SweepResult",
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
    the card unless the caller names another.
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
        with phase("sweep/expand"):
            self.oracle = Oracle(padded.nodes)
            pods: List[dict] = []
            pods.extend(wl.pods_excluding_daemon_sets(padded))
            for ds in padded.daemon_sets:
                pods.extend(wl.pods_from_daemon_set(ds, padded.nodes))
            for app in apps:
                app_pods = wl.generate_valid_pods_from_app(
                    app.name, app.resource, padded.nodes
                )
                if use_greed:
                    # same ordering the authoritative serial run will
                    # use (scheduler/core.py schedule_app): greed_sort
                    # ignores simon new nodes, so max-count padding and
                    # the per-count serial cluster sort pods identically
                    from ..scheduler.queues import greed_sort

                    app_pods = greed_sort(padded.nodes, app_pods)
                pods.extend(_sort_app_pods(app_pods))
            from ..scheduler.preemption import (
                build_priority_resolver,
                pod_uses_priority,
            )

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
            self.plan = fused_scan.build_plan(
                self.cluster_enc, self.batch, self.dyn, self.features,
                device=self.device,
            )

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
        GLOBAL.note("sweep-kernel", fused_scan.kernel_label(self.plan))

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

    def _scenario(self, count: int):
        valid = self.node_valid(count)
        return self.pod_active(valid), valid, self.batch.pinned_node

    def _result(self, count, valid, placements, final) -> ProbeResult:
        """Unscheduled count and utilization of one scan, on the host
        (the JAX package's _pallas_result arithmetic)."""
        placements = placements.cpu().numpy().astype(np.int64)
        v = valid[: self.n]
        alloc_c = np.asarray(self.cluster_enc.alloc_mcpu)
        alloc_m = np.asarray(self.cluster_enc.alloc_mem)
        denom_c = max(int(alloc_c[v].sum()), 1)
        denom_m = max(int(alloc_m[v].sum()), 1)
        used_c = final["used_mcpu"].cpu().numpy()
        used_m = final["used_mem"].cpu().numpy()
        cpu_util = 100.0 * float(used_c[v].sum()) / denom_c
        mem_util = 100.0 * float(used_m[v].sum()) / denom_m
        # the scan's final VG usage ([V, N]); a plan without the storage
        # block never grows it, so there the init is final
        vg_cap = np.asarray(self.cluster_enc.vg_cap)
        vg_used = (final["vg_used"].cpu().numpy().T if "vg_used" in final
                   else np.asarray(self.dyn.vg_used))
        denom_vg = max(int(vg_cap[v].sum()), 1)
        vg_util = 100.0 * float(vg_used[v].sum()) / denom_vg
        return ProbeResult(
            count=count,
            unscheduled=int((placements == -1).sum()),
            cpu_util=cpu_util,
            mem_util=mem_util,
            vg_util=vg_util,
            placements=placements,
        )

    def probe(self, count: int) -> ProbeResult:
        """Evaluate one candidate count: one masked scan (the
        `fused_scan_base` / `fused_scan_ext` kernel on a CUDA plan)."""
        from ..utils.trace import phase

        active, valid, pinned = self._scenario(count)
        with phase("sweep/probe"):
            placements, final = fused_scan.run_fused_scan(
                self.plan, self.batch.class_of_pod, active, valid, pinned=pinned
            )
            return self._result(count, valid, placements, final)

    def probe_counts(self, counts: List[int]) -> List[ProbeResult]:
        """Evaluate several counts in ONE launch of the scenario-batch
        kernel (`fused_scan_batch`), one block per count."""
        from ..utils.trace import phase

        scenarios = [self._scenario(c) for c in counts]
        with phase("sweep/probe"):
            rows = fused_scan.run_fused_scan_batch(
                self.plan, self.batch.class_of_pod, scenarios
            )
            return [
                self._result(c, valid, placements, final)
                for c, (_a, valid, _p), (placements, final)
                in zip(counts, scenarios, rows)
            ]

    def probe_pair(self, c1: int, c2: int):
        """Two candidate counts in one batch launch."""
        r1, r2 = self.probe_counts([c1, c2])
        return r1, r2

    def probe_many(self, counts: List[int]) -> SweepResult:
        """Evaluate many counts in one batch launch."""
        res = self.probe_counts(list(counts))
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

    def _search_gen(self, feasible, start: int = 0):
        """The min-count search as a COROUTINE: yields lists of counts
        to probe, receives {count: ProbeResult}, and returns the best
        result (or None) via StopIteration.

        Search shape (the JAX package's, on its kernel path): probe
        `start`; on failure escalate by the unscheduled-request estimate
        (with a doubling backstop) — asking for (hi-1, hi) together,
        since the estimate usually lands exactly — then bisect the
        bracket, confirming hi-1 first. Monotonicity (more nodes never
        schedule fewer pods) is what makes the bisection sound."""
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
            if hi - lo > 1 and hi not in probes and hi - 1 not in probes:
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
        """Probe the requested counts — two in one batch launch."""
        if len(req) == 2:
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


def sweep_node_counts(
    cluster: ResourceTypes,
    apps: List[AppResource],
    new_node_spec: Optional[dict],
    counts: List[int],
    use_greed: bool = False,
    score_weights=None,
    device=None,
) -> SweepResult:
    """Evaluate `counts` candidate new-node counts in one batch launch."""
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
    return sweep.probe_many(counts)
