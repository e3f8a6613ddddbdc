"""Head-to-head policy comparison over one shared trace.

Policies sharing a score profile ride ONE stepper — every window is a
single batched dispatch with one scenario row per policy. Policies with
a different profile (``@nospread``) need their own encoding (the scan's
score weights are compile-time static), so they group into a second
stepper over the same events; windows then dispatch per group, and the
merged report sums windows/dispatches across groups.
"""

from __future__ import annotations

from typing import List, Optional

from .autoscaler import Policy
from .events import Event
from .report import TimelineComparison
from .stepper import TimelineStepper


def run_policies(
    cluster,
    events: List[Event],
    policies: List[Policy],
    new_node_spec: Optional[dict] = None,
    max_nodes: int = 8,
    cadence_s: float = 60.0,
    warmup_s: float = 0.0,
    window_arrivals: int = 256,
    engine: str = "cuda",
    budget=None,
    journal=None,
    device=None,
) -> TimelineComparison:
    """Run every policy over `events` and merge the per-profile runs
    into one comparison (policy order preserved). A deadline/SIGINT
    halt re-raises ExecutionHalted with the merged partial report of
    every group finished or in flight attached."""
    from ..runtime.errors import ExecutionHalted

    groups: dict = {}
    for pol in policies:
        groups.setdefault(pol.profile, []).append(pol)
    merged: Optional[TimelineComparison] = None
    done: List[TimelineComparison] = []

    def merge(parts: List[TimelineComparison]) -> TimelineComparison:
        head = parts[0]
        out = TimelineComparison(
            trace_fingerprint=head.trace_fingerprint,
            events=head.events,
            arrivals=head.arrivals,
            windows=sum(p.windows for p in parts),
            dispatches=sum(p.dispatches for p in parts),
            horizon_s=head.horizon_s,
            engine=head.engine,
            partial=any(p.partial for p in parts),
            meta=dict(head.meta),
        )
        by_name = {}
        for part in parts:
            for tl in part.policies:
                by_name[tl.policy] = tl
        out.policies = [
            by_name[pol.name] for pol in policies if pol.name in by_name
        ]
        if len(parts) > 1:
            out.meta["profileGroups"] = len(parts)
        return out

    for profile, group in groups.items():
        stepper = TimelineStepper(
            cluster,
            events,
            group,
            new_node_spec=new_node_spec,
            max_nodes=max_nodes,
            cadence_s=cadence_s,
            warmup_s=warmup_s,
            window_arrivals=window_arrivals,
            engine=engine,
            score_weights=group[0].weights,
            budget=budget,
            journal=journal,
            journal_prefix=f"{profile}:" if len(groups) > 1 else "",
            device=device,
        )
        try:
            done.append(stepper.run())
        except ExecutionHalted as e:
            partial = getattr(e, "partial_report", None)
            parts = done + ([partial] if partial is not None else [])
            if parts:
                merged = merge(parts)
                merged.partial = True
                e.partial = {
                    "phase": "timeline",
                    "report": merged.as_dict(),
                }
                e.partial_report = merged
            raise
    return merge(done)
