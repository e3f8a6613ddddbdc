"""Fault-injection resilience: batched node-outage sweeps, N+K
capacity planning, and perturbation (cordon/taint/degrade) studies, on
the batch kernel's pins-first mode.

The reference answers "does this plan fit?"; this package answers
"does this plan *survive*?" — resilience/chaos.py holds the chaos
model and the engine.
"""

from .chaos import (  # noqa: F401
    ChaosEngine,
    ChaosReport,
    OutageScenario,
    ScenarioOutcome,
    perturbed_cluster,
    perturbed_scenario_sweep,
    raise_plan_to_nplusk,
    sampled_failure_sets,
)
