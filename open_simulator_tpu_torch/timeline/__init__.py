"""Discrete-event cluster timeline (`simon timeline`).

Everything else in the framework answers static questions — does this
fit, how many nodes, does the plan survive an outage, did the real
scheduler agree. The timeline adds the time axis: pod
arrivals and departures, node churn and spot reclamation, and a
simulated cluster-autoscaler closing the reference's interactive
add-node planner (pkg/apply/apply.go:186-239) over time, with
head-to-head policy comparison on one shared trace.

Modules:

- ``events``  — typed events, the deterministic event heap, the
  fingerprinted JSONL trace format, seeded synthetic generators
  (Poisson arrivals, exponential lifetimes, spot-reclaim hazard), and
  the shadow decision-log converter;
- ``stepper`` — the windowed stepper: consecutive arrivals batch into
  encode-once masked scan windows riding the chaos-style per-scenario
  (node_valid, pod_active, pinned) rows, so a 1000-step trace costs a
  handful of device dispatches instead of 1000 ``simulate()`` calls;
- ``autoscaler`` — the pluggable policy loop (static / threshold /
  capacity-probe) with decision cadence and node warm-up delay;
- ``compare``  — N policies as batched scenario rows over one trace;
- ``report``   — per-step cost/utilization/pending curves, text+JSON.
"""

from .events import (  # noqa: F401
    AUTOSCALE_DECISION,
    NODE_DRAIN,
    NODE_JOIN,
    POD_ARRIVAL,
    POD_DEPARTURE,
    SPOT_RECLAIM,
    Event,
    EventHeap,
    SyntheticSpec,
    TraceWriter,
    events_from_decision_log,
    generate_synthetic,
    read_trace,
    trace_fingerprint,
)
from .autoscaler import Policy, parse_policy  # noqa: F401
from .compare import run_policies  # noqa: F401
from .report import PolicyTimeline, TimelineComparison  # noqa: F401
from .stepper import TimelineStepper  # noqa: F401
