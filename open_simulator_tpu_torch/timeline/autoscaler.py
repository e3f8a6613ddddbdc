"""Pluggable autoscaler policies for the timeline's decision loop.

The stepper calls ``policy.decide(obs, probe=...)`` at every decision
cadence tick (including t=0) and applies the returned DELTA to the
candidate node pool: positive deltas enable candidates after the
configured warm-up delay, negative deltas drain the highest-index
enabled candidates immediately (their pods requeue through the full
filter+score cycle — the chaos displacement rule).

Policies:

- ``static:K``  — hold exactly K candidates up (the no-autoscaler
  baseline; K=0 is pure trace playback);
- ``threshold`` — scale up when pods are pending (by the stepper's
  aggregate-request node estimate), scale down one node after
  ``patience`` consecutive calm ticks (utilization under ``lo`` with
  nothing pending);
- ``probe``     — the capacity-probe policy: every decision evaluates
  ALL candidate counts as batched scenario rows over the live timeline
  state (one device dispatch — the sweep's probe_many pattern flattened
  into a single round) and jumps straight to the minimal count that
  schedules everything within apply's utilization caps
  (apply/applier._capacity_feasible — the same MaxCPU/MaxMemory/MaxVG
  contract ``simon apply`` plans under).

A policy spec may carry a score profile suffix: ``threshold@nospread``
runs the policy under ``ScoreWeights(spread=0)`` (PodTopologySpread
off — replicas pack onto fewer nodes instead of spreading; the closest
thing to a binpack study the reference's score-plugin set offers — it
registers no MostAllocated scorer, algorithmprovider/registry.go).
Policies with different profiles are grouped onto separate encodings by
the comparison harness (timeline/compare.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..models.validation import InputError
from ..scheduler.schedconfig import DEFAULT_SCORE_WEIGHTS, ScoreWeights

#: named score profiles a policy spec can select with ``@profile``
SCORE_PROFILES = {
    "default": None,  # the engine default (DEFAULT_SCORE_WEIGHTS)
    "nospread": DEFAULT_SCORE_WEIGHTS._replace(spread=0),
}


@dataclass
class PolicyObservation:
    """What a policy sees at a decision tick."""

    time: float
    pending: int  # pods currently waiting for a node
    pending_need_nodes: int  # candidate nodes the pending pods need by
    # aggregate request (stepper-computed, >= 1 when pending > 0)
    cpu_util: float
    mem_util: float
    nodes_up: int
    candidates_up: int  # enabled + warming (committed scale-ups)
    candidates_total: int


class Policy:
    """Base policy. Subclasses implement ``decide``; ``probe`` is a
    stepper-provided callable (counts -> per-count feasibility rows)
    that costs one device dispatch — only the probe policy uses it."""

    name: str = "policy"
    profile: str = "default"

    @property
    def weights(self) -> Optional[ScoreWeights]:
        return SCORE_PROFILES[self.profile]

    def decide(
        self, obs: PolicyObservation, probe: Optional[Callable] = None
    ) -> int:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class StaticPolicy(Policy):
    """Hold exactly ``count`` candidates up from t=0."""

    def __init__(self, count: int = 0):
        if count < 0:
            raise InputError(f"static policy count must be >= 0, got {count}")
        self.count = count
        self.name = f"static:{count}"

    def decide(self, obs, probe=None) -> int:
        return self.count - obs.candidates_up


class ThresholdPolicy(Policy):
    """Reactive scale-up on pending pods, patient scale-down on calm.

    Scale-up sizes itself from the stepper's aggregate-request estimate
    (``obs.pending_need_nodes``) so one decision absorbs a burst
    instead of trickling a node per tick; ``step`` > 0 caps it.
    Scale-down waits ``patience`` consecutive ticks with nothing
    pending and cpu AND mem under ``lo`` percent, then releases one
    node per tick — conservative by design (a reclaimed node's pods
    requeue, and thrashing is the classic autoscaler failure mode)."""

    def __init__(self, lo: float = 30.0, patience: int = 2, step: int = 0):
        if not 0 <= lo <= 100:
            raise InputError(f"threshold lo={lo} outside [0, 100]")
        if patience < 1:
            raise InputError(f"threshold patience must be >= 1, got {patience}")
        if step < 0:
            raise InputError(f"threshold step must be >= 0, got {step}")
        self.lo = lo
        self.patience = patience
        self.step = step
        self._calm = 0
        self.name = "threshold"

    def decide(self, obs, probe=None) -> int:
        if obs.pending > 0:
            self._calm = 0
            up = max(obs.pending_need_nodes, 1)
            if self.step:
                up = min(up, self.step)
            return min(up, obs.candidates_total - obs.candidates_up)
        if (
            obs.candidates_up > 0
            and obs.cpu_util < self.lo
            and obs.mem_util < self.lo
        ):
            self._calm += 1
            if self._calm >= self.patience:
                self._calm = 0
                return -1
        else:
            self._calm = 0
        return 0


class ProbePolicy(Policy):
    """Capacity-probe policy: pick the minimal candidate count that
    schedules everything within apply's utilization caps, re-evaluated
    from live timeline state at every tick (one batched dispatch)."""

    def __init__(self):
        self.name = "probe"

    def decide(self, obs, probe=None) -> int:
        if probe is None or obs.candidates_total == 0:
            return 0
        from ..apply.applier import _capacity_feasible

        feasible, _caps = _capacity_feasible()
        rows = probe(list(range(obs.candidates_total + 1)))
        for row in rows:  # rows arrive in ascending count order
            if feasible(row):
                return int(row.count) - obs.candidates_up
        # nothing feasible even with every candidate: take them all —
        # partial relief beats none, and the report shows the residue
        return obs.candidates_total - obs.candidates_up


def parse_policy(spec: str) -> Policy:
    """``name[:args][@profile]`` -> Policy. Examples: ``static:3``,
    ``threshold``, ``threshold:lo=20,patience=3``, ``probe@nospread``."""
    body, _, profile = spec.partition("@")
    profile = profile or "default"
    if profile not in SCORE_PROFILES:
        raise InputError(
            f"unknown score profile {profile!r} (have: "
            f"{', '.join(sorted(SCORE_PROFILES))})"
        )
    name, _, argstr = body.partition(":")
    kwargs = {}
    if name == "static":
        if not argstr:
            raise InputError("static policy needs a count: static:K")
        try:
            policy = StaticPolicy(int(argstr))
        except ValueError as e:
            raise InputError(f"static policy count {argstr!r}: {e}") from e
    elif name == "threshold":
        for part in filter(None, argstr.split(",")):
            k, sep, v = part.partition("=")
            if not sep:
                raise InputError(
                    f"threshold arg {part!r}: expected key=value"
                )
            kwargs[k] = v
        try:
            policy = ThresholdPolicy(
                lo=float(kwargs.pop("lo", 30.0)),
                patience=int(kwargs.pop("patience", 2)),
                step=int(kwargs.pop("step", 0)),
            )
        except ValueError as e:
            raise InputError(f"threshold policy args {argstr!r}: {e}") from e
        if kwargs:
            raise InputError(
                f"unknown threshold arg(s): {', '.join(sorted(kwargs))}"
            )
    elif name == "probe":
        if argstr:
            raise InputError("probe policy takes no args")
        policy = ProbePolicy()
    else:
        raise InputError(
            f"unknown policy {name!r} (have: static:K, threshold, probe)"
        )
    policy.profile = profile
    if profile != "default":
        policy.name = f"{policy.name}@{profile}"
    return policy


def parse_policies(specs: List[str]) -> List[Policy]:
    out = [parse_policy(s) for s in specs]
    names = [p.name for p in out]
    if len(set(names)) != len(names):
        raise InputError(f"duplicate policy names in {names}")
    return out
