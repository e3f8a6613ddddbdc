"""Live-cluster decision ingestor — watch-style polling over the
LIST-only KubeClient.

The reference's fake-apiserver layer imports a snapshot once
(models/kubeclient.py); shadow mode needs the OTHER half: a stream of
the decisions the production scheduler keeps making. A LIST-only
client cannot watch, so the tailer polls: each ``poll()`` re-lists
pods (and nodes) with the chunked, resourceVersion-anchored pager and
diffs against the previous poll's state, normalizing every observed
change into decision-log steps (shadow/log.py):

- a pod newly carrying ``spec.nodeName`` -> one ``decision`` step (the
  pod is recorded UNBOUND — nodeName/status stripped — with the
  observed node as the real scheduler's choice);
- a pod newly marked unschedulable (``PodScheduled`` condition False,
  reason ``Unschedulable``) -> a failure ``decision`` carrying the
  condition's message (emitted once per pod until its state changes);
- a bound pod that disappeared -> an ``evict_pod`` delta;
- node add/remove -> ``add_node`` / ``remove_node`` deltas.

Decision provenance: the poller ALSO lists the apiserver's Event
objects (``/api/v1/events``) when that endpoint answers — the
scheduler's own ``Scheduled`` / ``FailedScheduling`` events are the
closest thing a LIST-only client gets to the Binding objects
themselves. An observed binding corroborated by a ``Scheduled`` event
counts as an event-sourced decision
(``shadow_ingest_event_decisions_total``); one inferred purely from
the pod diff counts ``shadow_ingest_diff_decisions_total`` — the two
counters make the inference tail measurable instead of silent. A
``FailedScheduling`` event's message (the scheduler's full reason
text) wins over the pod condition's when both exist. Clusters whose
apiserver does not expose the events endpoint probe it ONCE, count
``shadow_ingest_events_unsupported_total``, and fall back to pure
diff inference forever after.

``bootstrap()`` turns the first LIST into the starting state: the node
list plus one ``place_pod`` delta step for every already-bound pod, so
the replayer's mirror begins from the cluster as found. Each pod LIST's
apiserver resourceVersion is recorded (``last_rv``) for diagnostics and
snapshot ordering; WITHIN a list, an expired continue token re-pages
anchored at that version (kubeclient.list_with_rv) instead of forcing
one giant GET. Polling cost is one or two paged LISTs per interval,
which the retry/breaker machinery (runtime/retry.py) already hardens.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from ..utils.trace import COUNTERS
from .log import Step

PODS_PATH = "/api/v1/pods"
NODES_PATH = "/api/v1/nodes"
EVENTS_PATH = "/api/v1/events"


def _pod_key(pod: dict) -> Tuple[str, str]:
    meta = pod.get("metadata") or {}
    return (meta.get("namespace") or "default", meta.get("name", ""))


def _bound_node(pod: dict) -> Optional[str]:
    return (pod.get("spec") or {}).get("nodeName") or None


def _unschedulable_message(pod: dict) -> Optional[str]:
    for cond in ((pod.get("status") or {}).get("conditions")) or []:
        if (
            cond.get("type") == "PodScheduled"
            and cond.get("status") == "False"
            and cond.get("reason") == "Unschedulable"
        ):
            return cond.get("message") or "Unschedulable"
    return None


def _strip_binding(pod: dict) -> dict:
    """The decision records the pod as the scheduler SAW it: unbound,
    no status phase/conditions (the replayer probes this form)."""
    q = copy.deepcopy(pod)
    (q.get("spec") or {}).pop("nodeName", None)
    q.pop("status", None)
    return q


def _looks_unsupported(e: BaseException) -> bool:
    """Does this events-LIST failure mean the endpoint does not exist
    (latch off forever) rather than a transient flap (retry next
    poll)? The apiserver's spellings: HTTP 404 / 403, 'the server
    could not find the requested resource', 'Forbidden'."""
    msg = str(e).lower()
    return any(
        marker in msg
        for marker in ("404", "403", "could not find", "forbidden", "not found")
    )


def _scheduled_event_node(message: str) -> str:
    """Node name from a scheduler `Scheduled` event message
    ("Successfully assigned ns/pod to node-7" — the kube-scheduler's
    fixed format since Binding events exist)."""
    if " to " not in message:
        return ""
    return message.rsplit(" to ", 1)[1].strip()


class ClusterTailer:
    """Diff-based decision stream over one KubeClient, corroborated by
    scheduler Event objects when the apiserver exposes them."""

    def __init__(self, client):
        self.client = client
        self._seq = 0
        # (namespace, name) -> bound node (None = seen but unbound)
        self._pods: Dict[Tuple[str, str], Optional[str]] = {}
        self._failed: set = set()  # pods whose failure was already emitted
        self._nodes: Dict[str, dict] = {}
        # resourceVersion of the latest pod LIST (snapshot ordering)
        self.last_rv: Optional[str] = None
        # events endpoint support: None = unprobed, False = the probe
        # failed once (never retried: a 404/403 apiserver answers the
        # same way every poll), True = event-sourced provenance armed
        self._events_supported: Optional[bool] = None

    def _next(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    # -- event-object ingestion ---------------------------------------------

    def _poll_events(self) -> Dict[Tuple[str, str], Tuple[str, str]]:
        """Latest scheduler event per pod key: ``("scheduled", node)``
        or ``("failed", message)``. Empty on unsupported endpoints and
        transient failures (the pod diff then carries the round)."""
        if self._events_supported is False:
            return {}
        from ..runtime.errors import ExternalIOError

        try:
            items = self.client.list(EVENTS_PATH)
        except (ExternalIOError, OSError, ValueError) as e:
            # degrade to diff inference, never kill the tail — but
            # only LATCH unsupported on an error that actually says so
            # (404/403): a transient flap during the first poll must
            # not disable event provenance for the daemon's lifetime
            if self._events_supported is None and _looks_unsupported(e):
                self._events_supported = False
                COUNTERS.inc("shadow_ingest_events_unsupported_total")
            return {}
        self._events_supported = True
        out: Dict[Tuple[str, str], Tuple[str, str]] = {}
        for ev in items:
            if not isinstance(ev, dict):
                continue
            obj = ev.get("involvedObject") or {}
            if obj.get("kind") != "Pod" or not obj.get("name"):
                continue
            key = (obj.get("namespace") or "default", obj.get("name", ""))
            reason = ev.get("reason")
            if reason == "Scheduled":
                out[key] = (
                    "scheduled",
                    _scheduled_event_node(ev.get("message") or ""),
                )
            elif reason == "FailedScheduling":
                out[key] = ("failed", ev.get("message") or "")
        return out

    def bootstrap(self) -> Tuple[List[dict], List[Step]]:
        """First LIST: returns (nodes, steps) where steps place every
        already-bound pod onto the mirror."""
        nodes = self.client.list(NODES_PATH)
        pods, self.last_rv = self.client.list_with_rv(PODS_PATH)
        self._nodes = {
            (n.get("metadata") or {}).get("name", ""): n for n in nodes
        }
        steps: List[Step] = []
        ops = []
        for pod in pods:
            key = _pod_key(pod)
            node = _bound_node(pod)
            self._pods[key] = node
            if node and node in self._nodes:
                ops.append({"op": "place_pod", "pod": copy.deepcopy(pod)})
        if ops:
            steps.append(Step(seq=self._next(), kind="delta", deltas=ops))
        return nodes, steps

    def poll(self) -> List[Step]:
        """One diff round: LIST pods + nodes (+ events when exposed),
        emit steps for every observed change since the previous
        round."""
        steps: List[Step] = []
        events = self._poll_events()
        nodes = self.client.list(NODES_PATH)
        seen_nodes = {
            (n.get("metadata") or {}).get("name", ""): n for n in nodes
        }
        for name, node in seen_nodes.items():
            if name not in self._nodes:
                steps.append(
                    Step(
                        seq=self._next(),
                        kind="delta",
                        deltas=[{"op": "add_node", "node": copy.deepcopy(node)}],
                    )
                )
        removed_nodes = [n for n in self._nodes if n not in seen_nodes]
        pods, pods_rv = self.client.list_with_rv(PODS_PATH)
        self.last_rv = pods_rv
        seen: Dict[Tuple[str, str], Optional[str]] = {}
        for pod in pods:
            key = _pod_key(pod)
            node = _bound_node(pod)
            prev = self._pods.get(key, "absent")
            if node and prev in ("absent", None):
                if node not in seen_nodes:
                    # bound to a node this round's node LIST has not
                    # shown yet (the pod LIST races node creation):
                    # leave the pod OUT of `seen` so the next poll —
                    # after the add_node delta has landed — emits the
                    # decision instead of dropping it forever
                    continue
                seen[key] = node
                # provenance: a Scheduled event naming this pod (and
                # not contradicting the authoritative spec.nodeName)
                # makes this an event-sourced decision; otherwise the
                # binding was inferred from the pod diff alone
                ev = events.get(key)
                if ev is not None and ev[0] == "scheduled" and ev[1] in ("", node):
                    COUNTERS.inc("shadow_ingest_event_decisions_total")
                else:
                    if ev is not None and ev[0] == "scheduled":
                        # the event names a different node than the
                        # spec — trust the spec, flag the drift
                        COUNTERS.inc("shadow_ingest_event_mismatch_total")
                    COUNTERS.inc("shadow_ingest_diff_decisions_total")
                steps.append(
                    Step(
                        seq=self._next(),
                        kind="decision",
                        pod=_strip_binding(pod),
                        node=node,
                    )
                )
                self._failed.discard(key)
                continue
            seen[key] = node
            if node is None:
                msg = _unschedulable_message(pod)
                ev = events.get(key)
                if ev is not None and ev[0] == "failed" and ev[1]:
                    # the scheduler's own event text is the richer
                    # failure record; it also surfaces failures whose
                    # pod condition has not landed yet
                    msg = ev[1]
                    source = "event"
                else:
                    source = "diff"
                if msg is not None and key not in self._failed:
                    COUNTERS.inc(
                        f"shadow_ingest_{source}_decisions_total"
                    )
                    steps.append(
                        Step(
                            seq=self._next(),
                            kind="decision",
                            pod=_strip_binding(pod),
                            node=None,
                            reason=msg,
                        )
                    )
                    self._failed.add(key)
        # disappeared pods: evict from the mirror (skip pods whose node
        # also vanished — the remove_node reload drops them wholesale).
        # A vanished UNBOUND pod evicts too (no node): the mirror's
        # pending queue must not hold deleted pods forever — the twin
        # forecast requeues that queue (twin/queries.py). Failure dedup
        # state always clears, so a recreated same-name pod that is
        # unschedulable again gets a fresh decision
        evict_ops = []
        for key, node in self._pods.items():
            if key in seen:
                continue
            self._failed.discard(key)
            if node and node in seen_nodes:
                evict_ops.append(
                    {
                        "op": "evict_pod",
                        "namespace": key[0],
                        "name": key[1],
                        "node": node,
                    }
                )
            elif not node:
                evict_ops.append(
                    {"op": "evict_pod", "namespace": key[0], "name": key[1]}
                )
        if evict_ops:
            steps.append(Step(seq=self._next(), kind="delta", deltas=evict_ops))
        for name in removed_nodes:
            steps.append(
                Step(
                    seq=self._next(),
                    kind="delta",
                    deltas=[{"op": "remove_node", "name": name}],
                )
            )
        self._pods = seen
        self._nodes = seen_nodes
        return steps
