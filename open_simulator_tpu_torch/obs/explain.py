"""Per-pod placement explanations — "why did pod X land on node Y
(or fail)".

Upstream open-simulator's whole value proposition is an *explained*
placement report; the device-batched reimplementation computes per-node
feasibility and scores and then throws that signal away except for a
single failure reason. This recorder keeps it, on demand:

- serial path: ``Oracle._find_feasible`` records every node's filter
  verdict (the exact reason string + framework status code) and
  ``Oracle._select_and_bind`` records the weighted score vector over
  feasible nodes plus the chosen node — the same walk that made the
  decision, so the explanation can never disagree with it.
- scan path: committed placements replay onto the oracle IN ORDER
  (the engine-replay contract, scheduler/engine.py), so oracle state
  at a pod's replay step equals the serial cycle's state at that step;
  ``capture()`` runs the filter + score walk against that state at
  commit time and records the same data. Failed pods already take a
  serial ``_find_feasible`` pass for their reason — the hook rides it.
- provenance: the tiered priority engine annotates explanations with
  the scan round, tier count, and serial-escape events, so "this pod
  went through the serial preemption cycle in scan round 3" is part of
  the record.

Everything is guarded by ``EXPLAIN.enabled`` (one attribute read on
the hot paths) so a run without ``--explain`` pays nothing.

Stdlib-only at import time: the oracle imports this module at load.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# per-pod record cap: explanations are for humans; a 100k-pod batch
# with thousands of failures must not hold 100k score vectors
MAX_RECORDS = 200
# per-node verdict rows kept verbatim per pod; larger clusters keep
# counts per reason plus the first rows (the report's aggregate message
# is computed from the full counts either way)
MAX_VERDICT_ROWS = 64


@dataclass
class PodExplanation:
    """Everything recorded about one pod's scheduling decision."""

    namespace: str
    name: str
    # (node, reason-or-None-when-feasible, status code) in node order,
    # truncated at MAX_VERDICT_ROWS (truncated_nodes counts the rest)
    verdicts: List[Tuple[str, Optional[str], str]] = field(default_factory=list)
    truncated_nodes: int = 0
    # full aggregate: reason string -> node count (drives the failure
    # message, identical to the report's)
    reason_counts: Dict[str, int] = field(default_factory=dict)
    feasible_count: int = 0
    total_nodes: int = 0
    # (node, weighted score) for feasible nodes, same truncation
    scores: List[Tuple[str, int]] = field(default_factory=list)
    chosen_node: Optional[str] = None
    # provenance: engine path, scan round, tier count, escape/preemption
    provenance: Dict[str, object] = field(default_factory=dict)

    @property
    def key(self) -> Tuple[str, str]:
        return (self.namespace, self.name)

    def failure_message(self) -> str:
        """The same aggregate message the report carries for an
        unschedulable pod (Oracle._failure_message formula) — computed
        from the recorded per-node verdicts, so the explain block and
        the report can never name different failure reasons."""
        parts = ", ".join(
            f"{n} {r}" for r, n in sorted(self.reason_counts.items())
        )
        total = sum(self.reason_counts.values())
        return (
            f"failed to schedule pod ({self.namespace}/{self.name}): "
            f"Unschedulable: 0/{total} nodes are available: {parts}."
        )

    def as_dict(self) -> dict:
        out = {
            "namespace": self.namespace,
            "name": self.name,
            "scheduled": self.chosen_node is not None,
            "chosenNode": self.chosen_node,
            "feasibleNodes": self.feasible_count,
            "totalNodes": self.total_nodes,
            "verdicts": [
                {"node": n, "verdict": r or "feasible", "code": c}
                for n, r, c in self.verdicts
            ],
            "truncatedNodes": self.truncated_nodes,
        }
        if self.chosen_node is None and self.reason_counts:
            out["reason"] = self.failure_message()
            out["reasonCounts"] = dict(self.reason_counts)
        if self.scores:
            out["scores"] = [{"node": n, "score": s} for n, s in self.scores]
        if self.provenance:
            out["provenance"] = dict(self.provenance)
            # preemption-victim provenance as a first-class structured
            # block: a pod scheduled after an escape round names the
            # node it preempted on and its namespace-qualified victims,
            # so downstream consumers (the shadow auditor's
            # ordering-divergence class) can cite them without parsing
            # the free-form provenance map
            if "preempted" in self.provenance or "preemption_node" in self.provenance:
                out["preemption"] = {
                    "node": self.provenance.get("preemption_node"),
                    "victims": list(self.provenance.get("preempted") or []),
                }
        return out


class ExplainRecorder:
    """Process-wide explanation store. ``enable(target)`` arms it: a
    target of None records UNSCHEDULABLE pods (capped at MAX_RECORDS,
    first-come) plus preemption/escape provenance; a pod name (``name``
    or ``namespace/name``) records that pod's full decision — filter
    verdicts AND the score vector — even when it schedules. ``enabled``
    is a plain attribute so hot-path guards are one read."""

    def __init__(self):
        self.enabled = False
        self.target: Optional[str] = None
        self._lock = threading.Lock()
        self._records: Dict[Tuple[str, str], PodExplanation] = {}
        self._order: List[Tuple[str, str]] = []
        self.dropped = 0
        self._dropped_keys: set = set()
        # round/tier context stamped by the tiered scan engine
        self._context: Dict[str, object] = {}

    # -- lifecycle ----------------------------------------------------------

    def enable(self, target: Optional[str] = None):
        with self._lock:
            self._records = {}
            self._order = []
            self.dropped = 0
            self._dropped_keys = set()
            self._context = {}
            self.target = target or None
            self.enabled = True

    def disable(self):
        with self._lock:
            self.enabled = False
            self.target = None
            self._context = {}

    def reset(self):
        with self._lock:
            self._records = {}
            self._order = []
            self.dropped = 0
            self._dropped_keys = set()
            self._context = {}

    def snapshot(self) -> List[PodExplanation]:
        with self._lock:
            return [self._records[k] for k in self._order]

    # -- matching -----------------------------------------------------------

    @staticmethod
    def _pod_key(pod: dict) -> Tuple[str, str]:
        meta = pod.get("metadata") or {}
        return (meta.get("namespace") or "default", meta.get("name", ""))

    # unlocked `target` reads: set once by enable() before any hook
    # fires and only cleared by disable(); a stale read at the
    # boundary records or skips one pod, never corrupts state
    def wants(self, pod: dict) -> bool:  # simonlint: disable=CONC001
        """Callers guard with ``EXPLAIN.enabled and EXPLAIN.wants(pod)``
        so the disabled path never reaches this call."""
        if self.target is None:
            return True
        ns, name = self._pod_key(pod)
        return self.target == name or self.target == f"{ns}/{name}"

    def _note_dropped(self, key) -> None:  # simonlint: disable=CONC001
        """Caller holds self._lock. One accounting scheme everywhere:
        `dropped` is the count of UNIQUE pods the cap turned away
        (bounded key set so a pathological run cannot grow it)."""
        if len(self._dropped_keys) < (1 << 16):
            self._dropped_keys.add(key)
        self.dropped = len(self._dropped_keys)

    # unlocked `target` read: same boundary-staleness argument as wants()
    def should_record(self, pod: dict) -> bool:  # simonlint: disable=CONC001
        """``wants`` plus the record cap, checked BEFORE the caller
        collects per-node data: once the untargeted recorder is full,
        the hooks stop paying the O(nodes) verdict collection for pods
        that would only be dropped anyway."""
        if not self.wants(pod):
            return False
        if self.target is None:
            key = self._pod_key(pod)
            with self._lock:
                if len(self._records) >= MAX_RECORDS and key not in self._records:
                    self._note_dropped(key)
                    return False
        return True

    def _get(self, pod: dict, create: bool = True) -> Optional[PodExplanation]:  # simonlint: disable=CONC001
        """Caller holds self._lock."""
        key = self._pod_key(pod)
        rec = self._records.get(key)
        if rec is None:
            if not create:
                return None
            if self.target is None and len(self._records) >= MAX_RECORDS:
                self._note_dropped(key)
                return None
            rec = PodExplanation(namespace=key[0], name=key[1])
            self._records[key] = rec
            self._order.append(key)
        return rec

    # -- context (stamped by the scan engine) -------------------------------

    def set_context(self, **ctx):
        """Round/tier provenance merged into every record created while
        the context is in force (the tiered scan sets round=N per
        dispatch round; the replay window inherits it)."""
        with self._lock:
            self._context.update(ctx)

    def clear_context(self):
        with self._lock:
            self._context = {}

    # -- recording hooks ----------------------------------------------------

    def record_filter(self, pod: dict, verdicts, feasible_count: int):
        """From Oracle._find_feasible (or capture()): per-node verdict
        rows ``(node_name, reason_or_None, code)`` in node order.

        Untargeted mode creates records only for pods with NO feasible
        node (the failures the report will name) — a 100k-pod serial
        run must not fill the record cap with its first 200 successes
        and then drop the failures the flag exists to explain. A pod
        that already has a record (an earlier failing pass, a
        preemption retry) keeps updating it."""
        with self._lock:
            create = self.target is not None or feasible_count == 0
            rec = self._get(pod, create=create)
            if rec is None:
                return
            rec.total_nodes = len(verdicts)
            rec.feasible_count = feasible_count
            rec.verdicts = list(verdicts[:MAX_VERDICT_ROWS])
            rec.truncated_nodes = max(len(verdicts) - MAX_VERDICT_ROWS, 0)
            counts: Dict[str, int] = {}
            for _n, reason, _c in verdicts:
                if reason is not None:
                    counts[reason] = counts.get(reason, 0) + 1
            rec.reason_counts = counts
            if self._context:
                rec.provenance.update(self._context)

    def record_scores(self, pod: dict, scores, chosen: Optional[str]):
        """From Oracle._select_and_bind (or capture()): ``(node_name,
        weighted_score)`` over feasible nodes + the selected node.
        Untargeted mode only updates pods already on record (a failed
        pod rescued by preemption gets its final node stamped); full
        score vectors for scheduled pods are targeted-only."""
        with self._lock:
            rec = self._get(pod, create=self.target is not None)
            if rec is None:
                return
            rec.scores = list(scores[:MAX_VERDICT_ROWS])
            rec.chosen_node = chosen
            if self._context:
                rec.provenance.update(self._context)

    def annotate(self, pod: dict, **prov):
        """Merge provenance facts (escape round, preemption victims,
        engine path) into a pod's record, creating it if needed."""
        with self._lock:
            rec = self._get(pod)
            if rec is None:
                return
            rec.provenance.update(prov)

    # -- scan-path capture --------------------------------------------------

    def capture(self, oracle, pod: dict, node_idx: Optional[int]):
        """Record a scan-committed pod's explanation at replay-commit
        time: oracle state here equals the serial cycle's state at this
        pod's step (commits replay in order), so the filter verdicts
        and scores are exactly what the serial scheduler would have
        seen. ``node_idx`` is the scan's placement (None = failed; the
        failure path's own ``_find_feasible`` call records verdicts)."""
        feasible, _reasons, _codes = oracle._find_feasible(pod)
        # ^ the _find_feasible hook recorded the verdict rows
        if node_idx is None or not feasible:
            return
        scores = oracle._prioritize(pod, feasible)
        chosen = oracle.nodes[int(node_idx)].name
        self.record_scores(
            pod, [(ns.name, sc) for ns, sc in zip(feasible, scores)], chosen
        )
        self.annotate(pod, engine="scan-replay")


EXPLAIN = ExplainRecorder()


# ------------------------------------------------------------- rendering


def render_explanations(recorder: Optional[ExplainRecorder] = None) -> str:
    """Human-readable explain block (appended to the apply report).
    Imports the table renderer lazily — report imports models, and this
    module must stay import-light for the oracle."""
    from ..apply.report import render_table

    recorder = recorder or EXPLAIN
    records = recorder.snapshot()
    if not records:
        return (
            "Placement Explanations\n(no pods matched --explain"
            + (f" {recorder.target!r}" if recorder.target else "")
            + ")"
        )
    out = ["Placement Explanations"]
    for rec in records:
        out.append("")
        if rec.chosen_node is not None:
            head = (
                f"pod {rec.namespace}/{rec.name}: scheduled on "
                f"{rec.chosen_node} ({rec.feasible_count}/{rec.total_nodes} "
                "nodes feasible)"
            )
        else:
            head = f"pod {rec.namespace}/{rec.name}: {rec.failure_message()}"
        out.append(head)
        if rec.provenance:
            prov = ", ".join(f"{k}={v}" for k, v in sorted(rec.provenance.items()))
            out.append(f"  provenance: {prov}")
        score_of = dict(rec.scores)
        rows = []
        for node, reason, _code in rec.verdicts:
            verdict = "feasible" if reason is None else reason
            score = score_of.get(node)
            rows.append([node, verdict, "" if score is None else str(score)])
        if rows:
            out.append(render_table(["Node", "Filter Verdict", "Score"], rows))
        if rec.truncated_nodes:
            out.append(
                f"  ... {rec.truncated_nodes} more node(s) omitted "
                f"(per-pod cap {MAX_VERDICT_ROWS}; aggregate counts above "
                "cover all nodes)"
            )
    if recorder.dropped:
        out.append("")
        out.append(
            f"({recorder.dropped} additional pod(s) not recorded — "
            f"record cap {MAX_RECORDS}; pass --explain POD to target one)"
        )
    return "\n".join(out)


def explanations_dict(recorder: Optional[ExplainRecorder] = None) -> List[dict]:
    recorder = recorder or EXPLAIN
    return [rec.as_dict() for rec in recorder.snapshot()]
