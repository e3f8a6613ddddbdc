"""Timeline reports: per-step cost/utilization/pending curves per
policy, plus the head-to-head comparison rendering (text + JSON).

A sample is taken at every pod arrival and at every window boundary
(churn, autoscale decision, departure batch), so the curves have true
per-event granularity even though a whole window of arrivals rides one
device dispatch — intra-window points are reconstructed host-side from
the window's placements in arrival order (timeline/stepper.py).

"Cost" is node-seconds: the integral of up-node count over time (per
policy). It is deliberately unit-free — multiply by a per-node price to
get money; the comparison between policies is the point, not the
currency.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StepSample:
    """One point on a policy's curves."""

    time: float
    pending: int  # pods waiting for a node
    running: int  # scheduler-placed pods currently up
    nodes_up: int  # schedulable nodes (base + joined + candidates)
    candidates_up: int  # autoscaler candidates among nodes_up
    cpu_util: float  # percent over up-node allocatable
    mem_util: float
    cost_node_s: float  # cumulative node-seconds up to `time`

    def as_dict(self) -> dict:
        return {
            "time": round(self.time, 6),
            "pending": self.pending,
            "running": self.running,
            "nodesUp": self.nodes_up,
            "candidatesUp": self.candidates_up,
            "cpuUtil": round(self.cpu_util, 3),
            "memUtil": round(self.mem_util, 3),
            "costNodeSeconds": round(self.cost_node_s, 3),
        }


@dataclass
class PolicyTimeline:
    """One policy's run over the trace."""

    policy: str
    samples: List[StepSample] = field(default_factory=list)
    decisions: List[dict] = field(default_factory=list)
    displaced_total: int = 0  # pods requeued by drain/reclaim/scale-down
    displaced_by: dict = field(default_factory=dict)  # cause -> count
    lost_total: int = 0  # daemonset / node-bound pods lost with a node
    never_scheduled: int = 0  # pods that departed while still pending

    @property
    def final(self) -> Optional[StepSample]:
        return self.samples[-1] if self.samples else None

    @property
    def peak_pending(self) -> int:
        return max((s.pending for s in self.samples), default=0)

    @property
    def peak_nodes(self) -> int:
        return max((s.nodes_up for s in self.samples), default=0)

    def mean_util(self) -> tuple:
        """Time-weighted mean cpu/mem utilization over the samples."""
        if len(self.samples) < 2:
            s = self.final
            return (s.cpu_util, s.mem_util) if s else (0.0, 0.0)
        cpu = mem = span = 0.0
        for a, b in zip(self.samples, self.samples[1:]):
            dt = b.time - a.time
            cpu += a.cpu_util * dt
            mem += a.mem_util * dt
            span += dt
        if span <= 0:
            s = self.final
            return (s.cpu_util, s.mem_util)
        return (cpu / span, mem / span)

    def pending_seconds(self) -> float:
        """Integral of the pending-pod count over time — the policy's
        aggregate queueing pain (lower is better)."""
        total = 0.0
        for a, b in zip(self.samples, self.samples[1:]):
            total += a.pending * (b.time - a.time)
        return total

    def as_dict(self) -> dict:
        cpu, mem = self.mean_util()
        final = self.final
        return {
            "policy": self.policy,
            "finalPending": final.pending if final else 0,
            "peakPending": self.peak_pending,
            "pendingSeconds": round(self.pending_seconds(), 3),
            "meanCpuUtil": round(cpu, 3),
            "meanMemUtil": round(mem, 3),
            "peakNodes": self.peak_nodes,
            "finalNodes": final.nodes_up if final else 0,
            "costNodeSeconds": round(final.cost_node_s, 3) if final else 0.0,
            "displaced": self.displaced_total,
            "displacedBy": dict(sorted(self.displaced_by.items())),
            "lost": self.lost_total,
            "neverScheduled": self.never_scheduled,
            "decisions": list(self.decisions),
            "samples": [s.as_dict() for s in self.samples],
        }


@dataclass
class TimelineComparison:
    """N policies over one shared trace."""

    trace_fingerprint: str
    events: int
    arrivals: int
    windows: int
    # batched scan rounds (windows + policy probe decisions) — device
    # launches on engine=cuda, serial evaluations on engine=oracle
    dispatches: int
    horizon_s: float
    engine: str
    policies: List[PolicyTimeline] = field(default_factory=list)
    partial: bool = False
    meta: dict = field(default_factory=dict)

    def policy(self, name: str) -> Optional[PolicyTimeline]:
        for p in self.policies:
            if p.policy == name:
                return p
        return None

    def as_dict(self) -> dict:
        return {
            "traceFingerprint": self.trace_fingerprint,
            "events": self.events,
            "arrivals": self.arrivals,
            "windows": self.windows,
            "dispatches": self.dispatches,
            "horizonSeconds": round(self.horizon_s, 6),
            "engine": self.engine,
            "partial": self.partial,
            "meta": dict(self.meta),
            "policies": [p.as_dict() for p in self.policies],
        }

    def render_text(self, curve_points: int = 12) -> str:
        from ..apply.report import render_table

        lines = [
            f"Timeline: {self.arrivals} arrival(s) / {self.events} event(s) "
            f"over {self.horizon_s:.1f}s, {self.windows} window(s), "
            f"{self.dispatches} batched scan round(s), engine {self.engine}"
            + (" [PARTIAL]" if self.partial else ""),
        ]
        rows = []
        for p in self.policies:
            cpu, mem = p.mean_util()
            final = p.final
            ups = sum(1 for d in p.decisions if d.get("delta", 0) > 0)
            downs = sum(1 for d in p.decisions if d.get("delta", 0) < 0)
            rows.append([
                p.policy,
                str(final.pending if final else 0),
                str(p.peak_pending),
                f"{p.pending_seconds():.0f}",
                f"{cpu:.1f}%",
                f"{mem:.1f}%",
                str(p.peak_nodes),
                f"{final.cost_node_s:.0f}" if final else "0",
                f"+{ups}/-{downs}",
                str(p.displaced_total),
            ])
        lines.append(render_table(
            ["Policy", "Pending(end)", "Pending(peak)", "Pending·s",
             "CPU", "Mem", "Nodes(peak)", "Node·s", "Scale", "Displaced"],
            rows,
        ))
        # compact shared-time curve table: one row per sampled instant,
        # one "pending/nodes/cpu%" cell per policy. Cells are aligned
        # by TIME, not sample index — profile groups run separate
        # steppers whose boundary-sample counts differ, so index k is
        # not the same instant across groups; each cell shows the
        # policy's latest sample at or before the row's time
        # (step-function semantics).
        base = next((p for p in self.policies if p.samples), None)
        if base is not None and curve_points > 0:
            stride = max(len(base.samples) // curve_points, 1)
            picks = list(range(0, len(base.samples), stride))
            if picks[-1] != len(base.samples) - 1:
                picks.append(len(base.samples) - 1)
            cursors = [0] * len(self.policies)
            rows = []
            for k in picks:
                t = base.samples[k].time
                row = [f"{t:8.1f}"]
                for p_i, p in enumerate(self.policies):
                    if not p.samples:
                        row.append("-")
                        continue
                    c = cursors[p_i]
                    while (
                        c + 1 < len(p.samples)
                        and p.samples[c + 1].time <= t
                    ):
                        c += 1
                    cursors[p_i] = c
                    s = p.samples[c]
                    row.append(f"{s.pending}p/{s.nodes_up}n/{s.cpu_util:.0f}%")
                rows.append(row)
            lines.append("per-step curves (pending pods / nodes up / cpu):")
            lines.append(render_table(
                ["t(s)"] + [p.policy for p in self.policies], rows
            ))
        return "\n".join(lines)
