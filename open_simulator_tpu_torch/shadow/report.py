"""Divergence classification + the shadow audit report.

Every replayed decision lands in exactly one class:

- ``agree`` — simon chose the same node the real scheduler did (or
  both declared the pod unschedulable: agreement on infeasibility);
- ``node-divergence`` — both placed the pod, on different nodes (a
  scoring/tie-rule disagreement: the report attaches both nodes'
  filter verdicts and their positions in simon's weighted score
  vector);
- ``feasibility-divergence`` — one side placed the pod, the other
  declared it unschedulable (a filter disagreement: the report names
  the failing filter per disputed node);
- ``ordering-divergence`` — a disagreement with evidence that decision
  ORDER or preemption, not policy, explains it: the real decision
  carried eviction deltas (the production scheduler preempted), or
  simon's probe failed on a preemption-capable pod (effective priority
  above the committed minimum with preemption-helpable failure codes —
  the shadow probe is read-only and never evicts, so these are
  expected to need the ordering explanation, which the explain
  payload's preemption provenance cites).

There is deliberately no "unknown": the classifier is total over
(real outcome, simon outcome, evidence).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

CLASS_AGREE = "agree"
CLASS_NODE = "node-divergence"
CLASS_FEASIBILITY = "feasibility-divergence"
CLASS_ORDERING = "ordering-divergence"

DIVERGENCE_CLASSES = (CLASS_NODE, CLASS_FEASIBILITY, CLASS_ORDERING)

# full per-step detail is kept for this many divergences; the taxonomy
# histogram and counters cover the rest (a 100k-step replay against a
# badly drifted scheduler must not hold 100k score vectors)
MAX_DIVERGENCE_DETAILS = 200


def classify(
    real_node: Optional[str],
    simon_node: Optional[str],
    ordering_evidence: Optional[str],
) -> str:
    """Total classifier over one decision. ``ordering_evidence`` is a
    human-readable citation (or None); any disagreement with evidence
    becomes ordering-divergence."""
    if real_node == simon_node:
        return CLASS_AGREE
    if ordering_evidence:
        return CLASS_ORDERING
    if real_node is not None and simon_node is not None:
        return CLASS_NODE
    return CLASS_FEASIBILITY


@dataclass
class StepOutcome:
    """One classified replay step (detail payload built by the
    replayer only for divergent steps)."""

    seq: int
    pod: str  # namespace/name
    cls: str
    real_node: Optional[str]
    real_reason: str
    simon_node: Optional[str]
    simon_reason: str
    evidence: Optional[str] = None
    detail: Optional[dict] = None


@dataclass
class DivergenceReport:
    """Aggregated audit over one replay run."""

    fingerprint: str = ""
    engine: str = ""
    steps: int = 0  # log steps applied (decisions + deltas)
    decisions: int = 0
    taxonomy: Dict[str, int] = field(default_factory=dict)
    divergences: List[StepOutcome] = field(default_factory=list)
    truncated_divergences: int = 0
    reloads: int = 0  # oracle rebuilds forced by remove_node deltas
    dropped_records: int = 0  # torn log tail
    # warm-path accounting (obs/profile counters, stamped by finish()):
    # the port builds its kernels with nvcc where the JAX package
    # compiles with XLA, so its builds stand where the JAX report counts
    # recompiles, and its launches where that one counts dispatches
    build_steps: List[int] = field(default_factory=list)
    new_shape_builds: int = 0
    warm_builds: int = 0
    obs: Dict[str, int] = field(default_factory=dict)

    def add(self, outcome: StepOutcome):
        self.decisions += 1
        self.taxonomy[outcome.cls] = self.taxonomy.get(outcome.cls, 0) + 1
        if outcome.cls != CLASS_AGREE:
            if len(self.divergences) < MAX_DIVERGENCE_DETAILS:
                self.divergences.append(outcome)
            else:
                self.truncated_divergences += 1

    @property
    def agreements(self) -> int:
        return self.taxonomy.get(CLASS_AGREE, 0)

    @property
    def divergence_count(self) -> int:
        return self.decisions - self.agreements

    @property
    def agreement_rate(self) -> float:
        return self.agreements / self.decisions if self.decisions else 1.0

    def finish(self, obs_delta: dict):
        """Stamp the run's launch and build movement (obs/profile.py
        counters) — the warm-path contract as a measured number."""
        self.obs = {
            "launches": int(obs_delta.get("launches_total", 0)),
            "deviceLaunches": int(obs_delta.get("device_launches_total", 0)),
            "nvccBuilds": int(obs_delta.get("nvcc_builds_total", 0)),
            "launchesPerDecision": round(
                obs_delta.get("launches_total", 0) / max(self.decisions, 1), 4
            ),
        }

    def as_dict(self) -> dict:
        out = {
            "fingerprint": self.fingerprint,
            "engine": self.engine,
            "steps": self.steps,
            "decisions": self.decisions,
            "agreements": self.agreements,
            "agreementRate": round(self.agreement_rate, 6),
            "taxonomy": {
                cls: self.taxonomy.get(cls, 0)
                for cls in (CLASS_AGREE,) + DIVERGENCE_CLASSES
            },
            "reloads": self.reloads,
            "droppedRecords": self.dropped_records,
            "buildSteps": list(self.build_steps),
            "newShapeBuilds": self.new_shape_builds,
            "warmBuilds": self.warm_builds,
            "divergences": [],
            "truncatedDivergences": self.truncated_divergences,
        }
        if self.obs:
            out["obs"] = dict(self.obs)
        for d in self.divergences:
            rec = {
                "seq": d.seq,
                "pod": d.pod,
                "class": d.cls,
                "real": {"node": d.real_node, "reason": d.real_reason},
                "simon": {"node": d.simon_node, "reason": d.simon_reason},
            }
            if d.evidence:
                rec["evidence"] = d.evidence
            if d.detail:
                rec.update(d.detail)
            out["divergences"].append(rec)
        return out

    def as_json(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True)

    def render_text(self) -> str:
        from ..apply.report import render_table

        lines = [
            "Shadow Audit Report",
            f"  engine: {self.engine}   cluster: {self.fingerprint}",
            f"  steps replayed: {self.steps} ({self.decisions} decisions, "
            f"{self.reloads} reload(s))",
            f"  agreement: {self.agreements}/{self.decisions} "
            f"({self.agreement_rate * 100:.2f}%)",
        ]
        if self.obs:
            lines.append(
                f"  warm path: {self.obs['launches']} launches "
                f"({self.obs['deviceLaunches']} on the card), "
                f"{self.new_shape_builds} new-shape builds, "
                f"{self.warm_builds} warm builds"
            )
        lines.append("")
        rows = [
            [cls, str(self.taxonomy.get(cls, 0))]
            for cls in (CLASS_AGREE,) + DIVERGENCE_CLASSES
        ]
        lines.append(render_table(["Class", "Steps"], rows))
        for d in self.divergences:
            lines.append("")
            lines.append(
                f"step {d.seq} pod {d.pod}: {d.cls}\n"
                f"  real:  {d.real_node or 'UNSCHEDULABLE'}"
                + (f" ({d.real_reason})" if d.real_reason else "")
                + f"\n  simon: {d.simon_node or 'UNSCHEDULABLE'}"
                + (f" ({d.simon_reason})" if d.simon_reason else "")
            )
            if d.evidence:
                lines.append(f"  evidence: {d.evidence}")
            disputed = (d.detail or {}).get("disputedNodes") or {}
            if disputed:
                rows = [
                    [
                        name,
                        v.get("verdict", ""),
                        "" if v.get("score") is None else str(v["score"]),
                    ]
                    for name, v in sorted(disputed.items())
                ]
                lines.append(
                    render_table(["Disputed Node", "Filter Verdict", "Score"], rows)
                )
        if self.truncated_divergences:
            lines.append(
                f"\n({self.truncated_divergences} further divergence(s) "
                f"counted in the taxonomy only — detail cap "
                f"{MAX_DIVERGENCE_DETAILS})"
            )
        return "\n".join(lines)
