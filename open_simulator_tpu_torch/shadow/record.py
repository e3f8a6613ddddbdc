"""Record simon's own scheduling decisions as a shadow decision log.

``record_simulation`` drives the exact serial pipeline of
``scheduler/core.simulate`` (cluster workloads first, then each app in
order through the queue sorts) on the serial oracle, observing it
through the Simulator's ``decision_hook`` — the loop itself stays in
``scheduler/core.py``, so the recorder can never drift from the engine
it journals. Each cycle yields one Step: the UNSCHEDULED pod snapshot,
the node the cycle chose (or its failure reason), and — crucially —
the preemption evictions the cycle performed BEFORE the bind, attached
as ``evict_pod`` delta ops. Pre-bound pods (``spec.nodeName``) become
``place_pod`` deltas: they occupy capacity but were never scheduled.

The resulting log replays to 100% agreement by construction
(tests/test_torch_shadow.py): the replayer applies
a decision's deltas first, so its probe sees exactly the state the
serial cycle bound against — including post-eviction state for
preemptors. Any drift between the serial cycle and the replay probe is
therefore a real bug, not recording noise.

The recorder is also the seeded-fixture generator: tests mutate a
recorded log (rename the chosen node, drop an eviction delta) to
exercise every divergence class deterministically.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..models.decode import ResourceTypes
from ..models import workloads as wl
from ..scheduler.core import AppResource, Simulator
from .log import Step


def _pod_key(pod: dict) -> Tuple[str, str]:
    meta = pod.get("metadata") or {}
    return (meta.get("namespace") or "default", meta.get("name", ""))


class _StepRecorder:
    """Simulator.decision_hook target: turns serial-loop events into
    log steps (the hook hands PRE-commit pod snapshots)."""

    def __init__(self, steps: List[Step]):
        self.steps = steps

    def prebound(self, pod: dict):
        self.steps.append(
            Step(
                seq=len(self.steps),
                kind="delta",
                deltas=[{"op": "place_pod", "pod": pod}],
            )
        )

    def decision(self, pod: dict, node_name: Optional[str], reason: str, evictions):
        deltas = []
        for ev in evictions:
            ns_name, v_name = _pod_key(ev.pod)
            deltas.append(
                {
                    "op": "evict_pod",
                    "namespace": ns_name,
                    "name": v_name,
                    "node": ev.node_name,
                    "preemptor": ev.preemptor,
                }
            )
        self.steps.append(
            Step(
                seq=len(self.steps),
                kind="decision",
                pod=pod,
                node=node_name,
                reason=reason if node_name is None else "",
                deltas=deltas,
            )
        )


def record_simulation(
    cluster: ResourceTypes,
    apps: List[AppResource],
    budget=None,
    use_greed: bool = False,
    steps_out: Optional[List[Step]] = None,
) -> List[Step]:
    """Run the serial simulation of ``cluster`` + ``apps`` and return
    its decisions as log steps, in commit order. The caller's cluster
    is not mutated (same ``copy()`` discipline as ``simulate()``); the
    generated-name counter is reset so repeated recordings of the same
    inputs produce the identical pod sequence. ``steps_out`` (a list
    the caller owns) receives steps as they happen, so a deadline halt
    still leaves the completed prefix — a valid, replayable log."""
    wl.reset_name_counter()
    steps: List[Step] = steps_out if steps_out is not None else []
    sim = Simulator(engine="oracle", use_greed=use_greed, budget=budget)
    sim.decision_hook = _StepRecorder(steps)
    sim.run_cluster(cluster.copy(), build_status=False)
    for app in apps:
        if budget is not None:
            budget.check(f"shadow recording app boundary ({app.name})")
        sim.schedule_app(app, build_status=False)
    return steps
