"""Fault-injection engine: batched node-outage sweeps over a committed
placement. The port's copy of the JAX package's resilience/chaos.py.

The capacity sweep (parallel/sweep.py) already evaluates masked
node-subset scenarios — exactly the substrate a survivability analysis
needs: every outage scenario is one more row of the batch kernel's
pins-first mode (CapacitySweep.probe_scenarios: the survivors' pins
commit, then the displaced pods schedule, each scenario on its own
cluster of blocks), so a full K-failure sweep costs one launch a chunk
instead of thousands of serial re-simulations.

Chaos model:

- Start from a COMMITTED placement (the minimal feasible capacity
  plan's scan placements, or any probe's).
- An outage scenario fails a set of nodes. Pods the scheduler placed on
  surviving nodes STAY THERE (pinned in the scan — real rescheduling
  cannot move survivors); pods displaced from failed nodes are free and
  reschedule through the full filter+score cycle against the residual
  capacity. Daemonset pods die with their node (the controller would
  not recreate them elsewhere); pods whose ORIGINAL spec.nodeName names
  a failed node are node-bound and cannot move.
- Single-node failures are enumerated exhaustively; K-node failures by
  deterministic seeded sampling over the Go math/rand port
  (utils/gorand.py), so a report is reproducible from (seed, trials).
- Perturbations (cordon / taint / capacity degradation) mutate the
  cluster the scenarios are evaluated against, while the committed
  baseline stays the clean cluster's: "the plan was committed, THEN the
  world got worse".

Failing scenarios are explained by replaying the scan placements into
host oracle state (apply/applier.py replay_masked) and asking the
oracle why each displaced pod found no node. An N+K capacity plan
(raise_plan_to_nplusk, `simon apply --tolerate-node-failures K`)
escalates the planned node count until every evaluated scenario
survives, then re-simulates one sampled outage SERIALLY
(CapacitySweep.serial_scenario) as an independent confirmation.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from math import comb
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..models.validation import InputError
from ..parallel.sweep import CapacitySweep, ProbeResult
from ..utils.gorand import GoRand

# failing scenarios explained (oracle reason per failed pod) before the
# report degrades to counts-only rows; a 100-scenario sweep with many
# failures must not pay 100 host replays to describe itself
MAX_EXPLAINED_SCENARIOS = 5
MAX_REASONS_PER_SCENARIO = 10


@dataclass
class OutageScenario:
    kind: str  # "single" | "multi" | "sampled" | "replacement"
    failed: Tuple[int, ...]  # sweep node indices that fail
    failed_names: Tuple[str, ...]

    def label(self) -> str:
        return "+".join(self.failed_names) if self.failed_names else "(no outage)"


@dataclass
class ScenarioOutcome:
    scenario: OutageScenario
    displaced: int  # scheduler-placed pods whose node failed
    rescheduled: int  # displaced pods that found a new node
    unschedulable: int  # NEWLY unschedulable (was placed at baseline)
    baseline_unsched: int  # already failing at baseline, still failing
    lost_daemonset: int  # daemonset pods that die with their node
    lost_node_bound: int  # original spec.nodeName pods on a failed node
    cpu_util: float  # surviving-node utilization after rescheduling
    mem_util: float
    reasons: List[Tuple[str, str]] = field(default_factory=list)
    # sweep pod indices of the newly-unschedulable pods (bounded by the
    # pod count of one scenario; the N+K escalation reads these to
    # prove a failure unreachable by adding nodes)
    unschedulable_pods: Tuple[int, ...] = ()

    @property
    def survives(self) -> bool:
        return self.unschedulable == 0


@dataclass
class ChaosReport:
    failures: int
    seed: int
    mode: str  # how the scenario set was generated
    baseline_count: int  # committed new-node count
    baseline_unscheduled: int
    outcomes: List[ScenarioOutcome] = field(default_factory=list)
    serial_confirmed: Optional[str] = None  # label of the serially
    # re-simulated scenario, set by confirm_serial on success
    # deadline/SIGINT halted the sweep at a chunk boundary: `outcomes`
    # holds only the completed scenarios out of `planned`
    partial: bool = False
    planned: int = 0  # scenarios the full sweep would evaluate

    @property
    def total(self) -> int:
        return len(self.outcomes)

    @property
    def survived(self) -> int:
        return sum(1 for o in self.outcomes if o.survives)

    @property
    def all_survived(self) -> bool:
        return self.survived == self.total

    def worst(self) -> Optional[ScenarioOutcome]:
        if not self.outcomes:
            return None
        return max(
            self.outcomes, key=lambda o: (o.unschedulable, o.displaced)
        )

    def as_dict(self) -> dict:
        return {
            "failures": self.failures,
            "seed": self.seed,
            "mode": self.mode,
            "baselineNewNodeCount": self.baseline_count,
            "baselineUnscheduled": self.baseline_unscheduled,
            "survived": self.survived,
            "total": self.total,
            "partial": self.partial,
            "plannedScenarios": self.planned or self.total,
            "serialConfirmed": self.serial_confirmed,
            "scenarios": [
                {
                    "kind": o.scenario.kind,
                    "failedNodes": list(o.scenario.failed_names),
                    "displaced": o.displaced,
                    "rescheduled": o.rescheduled,
                    "unschedulable": o.unschedulable,
                    "baselineUnscheduled": o.baseline_unsched,
                    "lostDaemonSet": o.lost_daemonset,
                    "lostNodeBound": o.lost_node_bound,
                    "cpuUtil": round(o.cpu_util, 2),
                    "memUtil": round(o.mem_util, 2),
                    "survives": o.survives,
                    "reasons": [
                        {"pod": p, "reason": r} for p, r in o.reasons
                    ],
                }
                for o in self.outcomes
            ],
        }

    def render_text(self) -> str:
        from ..apply.report import render_table

        lines = [
            f"Fault-injection survivability: K={self.failures}, "
            f"{self.total} scenario(s) ({self.mode}), seed {self.seed}",
        ]
        if self.partial:
            lines.append(
                f"PARTIAL: {self.total}/{self.planned} scenario(s) "
                "evaluated before the run halted (deadline/interrupt)"
            )
        lines += [
            f"baseline: {self.baseline_count} new node(s), "
            f"{self.baseline_unscheduled} unschedulable pod(s)",
            f"SURVIVED {self.survived}/{self.total} scenario(s)"
            + (
                f" — serial re-simulation confirmed [{self.serial_confirmed}]"
                if self.serial_confirmed
                else ""
            ),
        ]
        rows = [
            [
                o.scenario.label(),
                str(o.displaced),
                str(o.rescheduled),
                str(o.unschedulable),
                str(o.lost_daemonset),
                str(o.lost_node_bound),
                f"{o.cpu_util:.1f}%",
                f"{o.mem_util:.1f}%",
                "yes" if o.survives else "NO",
            ]
            for o in self.outcomes
        ]
        lines.append(
            render_table(
                [
                    "Failed Node(s)",
                    "Displaced",
                    "Rescheduled",
                    "Unschedulable",
                    "Lost(ds)",
                    "Lost(bound)",
                    "CPU",
                    "Mem",
                    "Survives",
                ],
                rows,
            )
        )
        for o in self.outcomes:
            if o.reasons:
                lines.append(f"unschedulable pods of [{o.scenario.label()}]:")
                for pod_ref, reason in o.reasons:
                    lines.append(f"  {pod_ref}: {reason}")
        return "\n".join(lines)


def sampled_failure_sets(
    eligible: Sequence[int], k: int, trials: int, seed: int
) -> Tuple[List[Tuple[int, ...]], str]:
    """K-subsets of `eligible` to fail: exhaustive when the space is no
    larger than `trials`, otherwise `trials` deterministic draws from
    the seeded Go math/rand stream (partial Fisher-Yates per draw;
    duplicates collapse). Returns (sorted index tuples, mode)."""
    elig = sorted(eligible)
    if k > len(elig):
        raise InputError(
            f"cannot fail {k} of {len(elig)} node(s); lower --failures"
        )
    if comb(len(elig), k) <= trials:
        return [tuple(c) for c in itertools.combinations(elig, k)], "exhaustive"
    rng = GoRand(seed)
    seen = set()
    out: List[Tuple[int, ...]] = []
    for _ in range(trials):
        pool = list(elig)
        pick = [pool.pop(rng.intn(len(pool))) for _ in range(k)]
        key = tuple(sorted(pick))
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out, "sampled"


def perturbed_cluster(cluster, cordon=(), taints=(), degrade=None):
    """A copy of `cluster` with scheduling-visible perturbations applied
    to named base nodes: `cordon` marks nodes unschedulable
    (node.kubernetes.io/unschedulable semantics — existing pods stay,
    displaced pods cannot land there), `taints` is a sequence of
    (node_names_or_None, taint_dict) appended to node specs (None =
    every base node), `degrade` is (percent, node_names_or_None) scaling
    allocatable cpu/memory DOWN by `percent` (a brownout: the nodes
    still exist but answer for less capacity)."""
    import copy as copymod

    from ..utils.quantity import q_milli, q_value

    cordon = set(cordon or ())
    taints = list(taints or ())
    affected = set(cordon)
    for names, _ in taints:
        affected |= set(names) if names else {None}
    if degrade is not None:
        pct, names = degrade
        if not 0 <= pct <= 100:
            raise InputError(f"degrade percent {pct} outside [0, 100]")
        affected |= set(names) if names else {None}
    out = cluster.copy()
    out.nodes = []
    known = set()
    for node in cluster.nodes:
        name = (node.get("metadata") or {}).get("name")
        known.add(name)
        hit = name in affected or None in affected
        node = copymod.deepcopy(node) if hit else node
        if name in cordon:
            node.setdefault("spec", {})["unschedulable"] = True
        for names, taint in taints:
            if names is None or name in names:
                node.setdefault("spec", {}).setdefault("taints", []).append(
                    dict(taint)
                )
        if degrade is not None:
            pct, names = degrade
            if names is None or name in names:
                scale = (100 - pct) / 100.0
                for section in ("allocatable", "capacity"):
                    res = (node.get("status") or {}).get(section)
                    if not res:
                        continue
                    if "cpu" in res:
                        res["cpu"] = f"{int(q_milli(res['cpu']) * scale)}m"
                    if "memory" in res:
                        res["memory"] = str(int(q_value(res["memory"]) * scale))
        out.nodes.append(node)
    for bad in (affected - {None}) - known:
        raise InputError(f"perturbation names unknown node {bad!r}")
    return out


def displaced_free_mask(placed, valid, had, active) -> np.ndarray:
    """Scheduler-placed pods whose node is outside `valid`: freed to
    reschedule through the full filter+score cycle — the chaos
    displacement rule (the timeline stepper shares it for node drains,
    spot reclaims and scale-downs, timeline/stepper.py). Node-bound pods
    (`had` — original spec.nodeName) and pods inactive in the scenario
    (daemonset pods of the failed node) are NOT displaced: they are
    lost with the node."""
    placed = np.asarray(placed)
    return (
        (~np.asarray(had))
        & (placed >= 0)
        & ~np.asarray(valid)[np.clip(placed, 0, None)]
        & np.asarray(active)
    )


def _pod_identity(pods) -> list:
    out = []
    for p in pods:
        meta = p.get("metadata") or {}
        out.append((meta.get("namespace"), meta.get("name")))
    return out


def perturbed_scenario_sweep(
    cluster,
    apps,
    new_node_spec,
    max_count: int,
    cordon=(),
    taints=(),
    degrade=None,
    use_greed: bool = False,
    score_weights=None,
    device=None,
) -> Optional[CapacitySweep]:
    """The perturbed re-encoding outage scenarios are evaluated
    against, or None when no perturbation was requested. Resets the
    workload name counter first so the expansion matches the baseline
    sweep's (the ChaosEngine constructor checks they are identical)."""
    if not cordon and not taints and degrade is None:
        return None
    from ..models.workloads import reset_name_counter

    reset_name_counter()
    return CapacitySweep(
        perturbed_cluster(cluster, cordon=cordon, taints=taints, degrade=degrade),
        apps,
        new_node_spec,
        max_count,
        use_greed=use_greed,
        score_weights=score_weights,
        device=device,
    )


class ChaosEngine:
    """Outage-scenario evaluation of one committed placement.

    `sweep` is the encoding the placement was committed on;
    `scenario_sweep` (optional) is a perturbed re-encoding of the same
    cluster the outages are evaluated against — the two must expand the
    identical pod sequence (checked), since placements are carried over
    by pod index. The sweeps' device (the card unless they were built
    elsewhere) runs every scenario."""

    def __init__(
        self,
        sweep: CapacitySweep,
        count: int,
        baseline_placements,
        scenario_sweep: Optional[CapacitySweep] = None,
    ):
        self.sweep = sweep
        self.scen = scenario_sweep or sweep
        if scenario_sweep is not None:
            if [ns.name for ns in sweep.oracle.nodes] != [
                ns.name for ns in scenario_sweep.oracle.nodes
            ] or _pod_identity(sweep.pods) != _pod_identity(scenario_sweep.pods):
                raise ValueError(
                    "perturbed cluster changed the node list or pod "
                    "expansion; chaos scenarios cannot carry the committed "
                    "placement over by index"
                )
        self.count = count
        self.base_valid = self.scen.node_valid(count)
        self.base_active = self.scen.pod_active(self.base_valid)
        self.baseline = np.asarray(baseline_placements).astype(np.int64)
        self.orig_pin = np.asarray(self.scen.batch.pinned_node).astype(np.int64)
        self.had = np.asarray(self.scen.had_node_name)
        self.node_names = [ns.name for ns in self.scen.oracle.nodes]

    @classmethod
    def from_cluster(
        cls,
        cluster,
        apps,
        new_node_spec=None,
        count: int = 0,
        use_greed: bool = False,
        score_weights=None,
        cordon=(),
        taints=(),
        degrade=None,
        device=None,
    ) -> "ChaosEngine":
        """Encode the cluster at the committed count, probe the baseline
        placement, and (when perturbations are given) re-encode the
        perturbed variant for scenario evaluation. Workload expansion
        names pods from a process-global counter, so it is reset before
        each encoding — the two expansions must be identical for
        placements to carry over by index."""
        from ..models.workloads import reset_name_counter

        reset_name_counter()
        sweep = CapacitySweep(
            cluster, apps, new_node_spec, count,
            use_greed=use_greed, score_weights=score_weights, device=device,
        )
        baseline = sweep.probe(count).placements
        scen_sweep = perturbed_scenario_sweep(
            cluster, apps, new_node_spec, count,
            cordon=cordon, taints=taints, degrade=degrade,
            use_greed=use_greed, score_weights=score_weights, device=device,
        )
        return cls(sweep, count, baseline, scenario_sweep=scen_sweep)

    # -- scenario generation ------------------------------------------------

    def build_scenarios(
        self, failures: int, seed: int = 1, trials: int = 32
    ) -> Tuple[List[OutageScenario], str]:
        """Single-node outages exhaustively; K >= 2 adds seeded-sampled
        K-subsets (surviving K failures subsumes surviving fewer only
        scenario-by-scenario, so the singles stay in the set); K <= 0 is
        the replacement study (no outage, full re-placement — the
        perturbation-only question)."""
        names = self.node_names
        if failures <= 0:
            return [OutageScenario("replacement", (), ())], "replacement"
        elig = [i for i in range(self.scen.n) if self.base_valid[i]]
        scens = [
            OutageScenario("single", (i,), (names[i],)) for i in elig
        ]
        mode = "exhaustive singles"
        if failures >= 2:
            combos, sample_mode = sampled_failure_sets(
                elig, failures, trials, seed
            )
            scens.extend(
                OutageScenario(
                    "multi" if sample_mode == "exhaustive" else "sampled",
                    c,
                    tuple(names[i] for i in c),
                )
                for c in combos
            )
            mode = f"singles + {sample_mode} {failures}-subsets"
        return scens, mode

    def _masks(self, scen: OutageScenario):
        """(node_valid, pod_active, pinned, displaced_mask) for one
        scenario. Survivor pods pin to their committed nodes (pins
        commit unconditionally — the placement was feasible when
        committed); displaced scheduler-placed pods are freed; original
        spec.nodeName pins are kept verbatim so the scan's
        pinned-to-invalid INACTIVE convention marks them node-bound."""
        valid = self.base_valid.copy()
        for i in scen.failed:
            valid[i] = False
        active = self.scen.pod_active(valid)
        b = self.baseline
        if scen.kind == "replacement":
            pinned = np.where(self.had, self.orig_pin, -1).astype(np.int64)
            displaced = np.zeros(len(b), dtype=bool)
        else:
            pinned = np.where(
                self.had, self.orig_pin, np.where(b >= 0, b, -1)
            ).astype(np.int64)
            # pods inactive in the scenario (daemonset pods of failed
            # nodes) die with the node — lost, not displaced
            displaced = displaced_free_mask(b, valid, self.had, active)
            pinned[displaced] = -1
        return valid, active, pinned, displaced

    # -- evaluation ---------------------------------------------------------

    def _scenario_key(self, scen: OutageScenario) -> str:
        """Journal key of one scenario verdict: the committed count plus
        the failure set (the journal fingerprint already pins the
        config, flags, seed, and perturbations)."""
        return f"{self.count}:{scen.kind}:{'+'.join(scen.failed_names)}"

    @staticmethod
    def _outcome_record(o: ScenarioOutcome) -> dict:
        return {
            "scenKind": o.scenario.kind,
            "failed": [int(i) for i in o.scenario.failed],
            "failedNames": list(o.scenario.failed_names),
            "displaced": o.displaced,
            "rescheduled": o.rescheduled,
            "unschedulable": o.unschedulable,
            "baselineUnsched": o.baseline_unsched,
            "lostDaemonSet": o.lost_daemonset,
            "lostNodeBound": o.lost_node_bound,
            "cpuUtil": o.cpu_util,
            "memUtil": o.mem_util,
            "reasons": [[p, r] for p, r in o.reasons],
            "unschedulablePods": [int(i) for i in o.unschedulable_pods],
        }

    @staticmethod
    def _outcome_from_record(scen: OutageScenario, rec: dict) -> ScenarioOutcome:
        return ScenarioOutcome(
            scenario=scen,
            displaced=int(rec["displaced"]),
            rescheduled=int(rec["rescheduled"]),
            unschedulable=int(rec["unschedulable"]),
            baseline_unsched=int(rec["baselineUnsched"]),
            lost_daemonset=int(rec["lostDaemonSet"]),
            lost_node_bound=int(rec["lostNodeBound"]),
            cpu_util=float(rec["cpuUtil"]),
            mem_util=float(rec["memUtil"]),
            reasons=[(p, r) for p, r in rec.get("reasons") or []],
            unschedulable_pods=tuple(
                int(i) for i in rec.get("unschedulablePods") or ()
            ),
        )

    def _outcome(self, scen, masks, row, cpu, mem, explain_left) -> ScenarioOutcome:
        valid, active, _pinned, displaced = masks
        b = self.baseline
        newly = (row == -1) & (b >= 0)
        outcome = ScenarioOutcome(
            scenario=scen,
            displaced=int(displaced.sum()),
            rescheduled=int((displaced & (row >= 0)).sum()),
            unschedulable=int(newly.sum()),
            baseline_unsched=int(((row == -1) & (b == -1)).sum()),
            lost_daemonset=int((self.base_active & ~active).sum()),
            lost_node_bound=int(
                (
                    self.had
                    & (self.orig_pin >= 0)
                    & ~valid[np.clip(self.orig_pin, 0, None)]
                ).sum()
            ),
            cpu_util=float(cpu),
            mem_util=float(mem),
            unschedulable_pods=tuple(int(i) for i in np.flatnonzero(newly)),
        )
        if outcome.unschedulable and explain_left > 0:
            outcome.reasons = self._explain(valid, row, newly)
        return outcome

    def run(
        self,
        failures: int = 1,
        seed: int = 1,
        trials: int = 32,
        explain: int = MAX_EXPLAINED_SCENARIOS,
        budget=None,
        journal=None,
    ) -> ChaosReport:
        """Evaluate the scenario set against the committed placement.

        With a `journal`, scenarios whose verdict is already journaled
        are reconstructed without any device work and only the
        remainder rides the batched sweep; fresh verdicts are appended
        as they land. With a `budget`, the sweep halts between device
        chunks: the raised ExecutionHalted carries a PARTIAL ChaosReport
        (completed scenarios only, journaled) as its payload."""
        from ..runtime.errors import ExecutionHalted
        from ..utils.trace import GLOBAL, profiled

        scens, mode = self.build_scenarios(failures, seed, trials)
        report = ChaosReport(
            failures=failures,
            seed=seed,
            mode=mode,
            baseline_count=self.count,
            baseline_unscheduled=int((self.baseline == -1).sum()),
            planned=len(scens),
        )
        outcomes: List[Optional[ScenarioOutcome]] = [None] * len(scens)
        eval_idx: List[int] = []
        if journal is not None:
            for s_i, scen in enumerate(scens):
                rec = journal.get_scenario(self._scenario_key(scen))
                if rec is not None:
                    outcomes[s_i] = self._outcome_from_record(scen, rec)
                else:
                    eval_idx.append(s_i)
            if len(eval_idx) < len(scens):
                GLOBAL.append_note(
                    "chaos-journal",
                    f"count {self.count}: {len(scens) - len(eval_idx)}/"
                    f"{len(scens)} scenario verdict(s) replayed from the "
                    "journal",
                )
        else:
            eval_idx = list(range(len(scens)))

        masks = {s_i: self._masks(scens[s_i]) for s_i in eval_idx}
        halted = None
        rows: dict = {}
        if eval_idx:
            try:
                with profiled("chaos/sweep"):
                    placements, _unsched, cpu, mem, _vg = self.scen.probe_scenarios(
                        np.stack([masks[i][0] for i in eval_idx]),
                        np.stack([masks[i][1] for i in eval_idx]),
                        np.stack([masks[i][2] for i in eval_idx]),
                        budget=budget,
                    )
                rows = {
                    s_i: (placements[k], cpu[k], mem[k])
                    for k, s_i in enumerate(eval_idx)
                }
            except ExecutionHalted as e:
                halted = e
                partial = getattr(e, "partial_results", None) or []
                rows = {
                    s_i: (r[0], r[2], r[3])
                    for s_i, r in zip(eval_idx, partial)
                    if r is not None
                }
        explain_left = explain
        for s_i, scen in enumerate(scens):
            if outcomes[s_i] is not None:
                continue
            if s_i not in rows:
                continue
            row, cpu_i, mem_i = rows[s_i]
            outcome = self._outcome(
                scen, masks[s_i], row, cpu_i, mem_i, explain_left
            )
            if outcome.reasons:
                explain_left -= 1
            outcomes[s_i] = outcome
            if journal is not None:
                journal.record_scenario(
                    self._scenario_key(scen), self._outcome_record(outcome)
                )
        report.outcomes = [o for o in outcomes if o is not None]
        report.partial = halted is not None
        GLOBAL.note(
            "chaos-scenarios",
            f"{report.survived}/{report.total} survive (K={failures}, "
            f"{mode}, seed {seed})"
            + (f" [partial: {report.total}/{report.planned}]" if report.partial else ""),
        )
        if halted is not None:
            halted.partial = {"phase": "chaos-sweep", "report": report.as_dict()}
            # hand the assembled partial report to the caller too
            halted.partial_report = report
            raise halted
        return report

    def _explain(self, valid, row, newly) -> List[Tuple[str, str]]:
        """Oracle reasons for a failing scenario's newly-unschedulable
        pods: replay the scan placements into host state, then ask the
        FULLY-loaded oracle why each failed pod finds no node. (The
        replay's own at-position reasons would describe a half-empty
        cluster — chaos placements commit every survivor before any
        displaced pod, so only the end state explains the failure.)"""
        from ..apply.applier import replay_masked
        from ..scheduler.oracle import Oracle

        _result, oracle = replay_masked(self.scen, valid, row)
        out = []
        for p_i in np.flatnonzero(newly)[:MAX_REASONS_PER_SCENARIO]:
            pod = self.scen.pods[int(p_i)]
            meta = pod.get("metadata") or {}
            _, reasons_map, _ = oracle._find_feasible(pod)
            out.append(
                (
                    f"{meta.get('namespace') or 'default'}/{meta.get('name') or ''}",
                    Oracle._failure_message(pod, reasons_map),
                )
            )
        return out

    def confirm_serial(self, scen: OutageScenario) -> Tuple[bool, int]:
        """Independent confirmation: re-simulate one scenario through
        the serial oracle (no scan, no batching) and count newly
        unschedulable pods. (ok, newly_unschedulable)."""
        from ..utils.trace import GLOBAL, phase

        valid, active, pinned, _ = self._masks(scen)
        with phase("chaos/serial-confirm"):
            placements, _reasons = self.scen.serial_scenario(
                valid, active, pinned, pins_first=True
            )
        newly = int(((placements == -1) & (self.baseline >= 0)).sum())
        GLOBAL.note(
            "chaos-serial-confirm",
            f"[{scen.label()}]: "
            + ("ok" if newly == 0 else f"{newly} newly unschedulable"),
        )
        return newly == 0, newly


def _escalation_cannot_help(engine: "ChaosEngine", report: ChaosReport):
    """Proof that adding candidate nodes can NEVER rescue a failing
    scenario, so the escalation can stop instead of walking to
    max_count. Adding nodes helps a displaced pod two ways: directly
    (the pod lands on a new node) or indirectly (other pods move to the
    new nodes, freeing a surviving node the pod is allowed on). Both
    are impossible only when the pod is statically rejected
    (nodeSelector / taint / nodeName) by the candidate spec AND by
    every node surviving the scenario — or, for an open-local pod, when
    neither the spec nor any surviving node has local storage at all
    (capacity on storage nodes can be freed; absent VGs/devices
    cannot). Returns a human reason or None (the stagnation backstop
    handles the merely-slow cases)."""
    sweep = engine.scen
    if sweep.max_count == 0:
        return "no newNode spec to escalate with"
    sf = np.asarray(sweep.batch.static_feasible)
    cls = np.asarray(sweep.batch.class_of_pod)
    c_enc = sweep.cluster_enc
    new_i = sweep.n_base  # all candidate nodes share the spec
    new_has_storage = bool(
        c_enc.vg_cap[new_i].sum()
        or c_enc.ssd_cap[new_i].sum()
        or c_enc.hdd_cap[new_i].sum()
    )
    node_has_storage = (
        c_enc.vg_cap.sum(axis=1)
        + c_enc.ssd_cap.sum(axis=1)
        + c_enc.hdd_cap.sum(axis=1)
    ) > 0
    for o in report.outcomes:
        if o.survives:
            continue
        valid = engine.base_valid.copy()
        for i in o.scenario.failed:
            valid[i] = False
        for p_i in o.unschedulable_pods:
            why = None
            sf_p = sf[cls[p_i]]
            if not sf_p[new_i] and not (sf_p & valid).any():
                why = (
                    "statically rejected (nodeSelector/taint/nodeName) by "
                    "the candidate newNode spec and every surviving node"
                )
            elif (
                sweep.batch.wants_storage[cls[p_i]]
                and not new_has_storage
                and not (node_has_storage & valid).any()
            ):
                why = (
                    "wants open-local storage; neither the candidate "
                    "newNode spec nor any surviving node has any"
                )
            if why is not None:
                meta = sweep.pods[p_i].get("metadata") or {}
                return (
                    f"pod {meta.get('namespace', 'default')}/"
                    f"{meta.get('name', '')} in scenario "
                    f"[{o.scenario.label()}] {why}"
                )
    return None


def raise_plan_to_nplusk(
    sweep: CapacitySweep,
    best: ProbeResult,
    feasible,
    failures: int,
    seed: int = 1,
    trials: int = 32,
    budget=None,
    journal=None,
) -> Tuple[Optional[ProbeResult], Optional[ChaosReport]]:
    """Escalate a feasible capacity plan until its committed placement
    survives every evaluated K-failure scenario (`simon apply
    --tolerate-node-failures K`). Returns (probe, report); probe is
    None when N+K is unreachable — even at max_count, provably (a
    failing pod the candidate spec statically rejects), or after the
    failure set stagnates across escalations. A surviving plan is only
    returned after one sampled outage scenario re-simulates SERIALLY to
    the same verdict — a batched-scan bug must not certify a fake N+K
    plan.

    `budget` halts the escalation at its safe boundaries (between
    escalations and between device chunks) with a machine-readable
    partial payload; `journal` makes the escalation resumable — probe
    results ride the sweep's attached journal and every scenario
    verdict is appended as it lands, so a resumed run re-executes zero
    journaled work."""
    from ..runtime.errors import ExecutionHalted
    from ..utils.trace import GLOBAL

    probe = best
    stagnant = 0
    prev_failure_sig = None

    def _partial(exc, report=None):
        exc.partial = {
            "phase": "nplusk-escalation",
            "tolerateFailures": failures,
            "count": probe.count,
            "planFeasibleAtCount": True,
            "chaos": (exc.partial or {}).get("report")
            if isinstance(exc.partial, dict)
            else (report.as_dict() if report is not None else None),
        }
        return exc

    while True:
        if budget is not None:
            try:
                budget.check("N+K escalation boundary")
            except ExecutionHalted as e:
                raise _partial(e)
        engine = ChaosEngine(sweep, probe.count, probe.placements)
        try:
            report = engine.run(
                failures=failures, seed=seed, trials=trials, explain=0,
                budget=budget, journal=journal,
            )
        except ExecutionHalted as e:
            raise _partial(e)
        GLOBAL.append_note(
            "nplusk-escalation",
            f"count {probe.count}: {report.survived}/{report.total} survive",
        )
        if report.all_survived:
            worst = report.worst()
            ok, newly = engine.confirm_serial(worst.scenario)
            if not ok:  # pragma: no cover - defensive
                from ..runtime.errors import ConformanceError

                raise ConformanceError(
                    f"N+{failures} serial confirmation disagreed with the "
                    f"batched sweep on [{worst.scenario.label()}]: {newly} "
                    "newly unschedulable pod(s) in the serial re-simulation"
                )
            report.serial_confirmed = worst.scenario.label()
            return probe, report
        reason = _escalation_cannot_help(engine, report)
        if reason is not None:
            GLOBAL.note("nplusk-unreachable", reason)
            return None, report
        # stagnation backstop: identical failing scenarios with
        # identical failure counts across consecutive escalations mean
        # added nodes are not absorbing this outage (e.g. a pinned-pod
        # capacity hole) — stop after three no-progress rounds
        sig = tuple(
            (o.scenario.failed, o.unschedulable)
            for o in report.outcomes
            if not o.survives
        )
        if sig == prev_failure_sig:
            stagnant += 1
            if stagnant >= 3:
                GLOBAL.note(
                    "nplusk-unreachable",
                    f"failure set unchanged for {stagnant} escalations "
                    f"at count {probe.count}",
                )
                return None, report
        else:
            stagnant = 0
            prev_failure_sig = sig
        if probe.count >= sweep.max_count:
            return None, report
        count = probe.count + 1
        while count <= sweep.max_count:
            # each escalation probe is a device scan; without a check
            # here a deadline expiring mid-escalation would not halt
            # until the next outer N+K boundary (RT001)
            if budget is not None:
                try:
                    budget.check("N+K escalation probe")
                except ExecutionHalted as e:
                    raise _partial(e, report)
            candidate = sweep.probe(count)
            if feasible(candidate):
                probe = candidate
                break
            count += 1
        else:
            return None, report
