"""Timeline events: the typed model, the deterministic heap, the trace
file format, synthetic generators, and the shadow-log converter.

Event kinds (format version 1):

- ``PodArrival``   — a pod enters the cluster and wants scheduling (a
  pod arriving with ``spec.nodeName`` set occupies its node unscheduled,
  like the scan's original-pin convention);
- ``PodDeparture`` — a pod (named by ``namespace/name``) finishes and
  releases its capacity. The windowed stepper applies departures at the
  close of the window they fall in (docs/TIMELINE.md, "quantization");
- ``NodeJoin``     — a node (full spec carried in the event) becomes
  schedulable;
- ``NodeDrain``    — a node leaves gracefully: its scheduler-placed
  pods requeue through the full filter+score cycle;
- ``SpotReclaim``  — a spot node is reclaimed: identical displacement
  semantics to the chaos engine's outages (daemonset pods die with the
  node, original ``spec.nodeName`` pods are node-bound and lost);
- ``AutoscaleDecision`` — a recorded scale delta on the candidate node
  pool (written into reports by the policy loop; honored verbatim when
  present in an INPUT trace, so one run's decisions can be replayed
  against another workload).

Ordering is total and deterministic: ``(time, seq)`` with ``seq``
assigned in insertion order — equal-time events are FIFO, so a trace
replays byte-identically regardless of heap internals.

The trace file is JSONL riding the journal discipline
(runtime/journal.py): a fingerprinted header line, one event per line,
flushed+fsync'd per append, torn final line tolerated on read, interior
damage and fingerprint mismatches refused loudly.
"""

from __future__ import annotations

import heapq
import json
import math
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from ..runtime.journal import JournalMismatch, config_fingerprint
from ..utils.gorand import GoRand

TRACE_VERSION = 1
TRACE_FORMAT = "timeline-trace"

POD_ARRIVAL = "PodArrival"
POD_DEPARTURE = "PodDeparture"
NODE_JOIN = "NodeJoin"
NODE_DRAIN = "NodeDrain"
SPOT_RECLAIM = "SpotReclaim"
AUTOSCALE_DECISION = "AutoscaleDecision"

EVENT_KINDS = (
    POD_ARRIVAL,
    POD_DEPARTURE,
    NODE_JOIN,
    NODE_DRAIN,
    SPOT_RECLAIM,
    AUTOSCALE_DECISION,
)

# kinds that change node capacity: the windowed stepper breaks a scan
# window at every one of these (stepper.py BOUNDARY_KINDS reads this)
CHURN_KINDS = (NODE_JOIN, NODE_DRAIN, SPOT_RECLAIM, AUTOSCALE_DECISION)


@dataclass
class Event:
    """One timeline event. ``time`` is seconds since trace start;
    ``seq`` totals the order (assigned by the heap / reader)."""

    time: float
    kind: str
    seq: int = 0
    pod: Optional[dict] = None  # PodArrival: the full pod object
    pod_ref: str = ""  # PodDeparture: "namespace/name"
    node: Optional[dict] = None  # NodeJoin: the full node object
    node_name: str = ""  # NodeDrain / SpotReclaim
    delta: int = 0  # AutoscaleDecision: candidate-pool delta
    reason: str = ""  # free-form provenance ("hazard", "policy:x")

    def key(self) -> Tuple[float, int]:
        return (self.time, self.seq)

    def as_record(self) -> dict:
        rec = {"kind": "event", "event": self.kind, "time": self.time,
               "seq": self.seq}
        if self.pod is not None:
            rec["pod"] = self.pod
        if self.pod_ref:
            rec["podRef"] = self.pod_ref
        if self.node is not None:
            rec["node"] = self.node
        if self.node_name:
            rec["nodeName"] = self.node_name
        if self.delta:
            rec["delta"] = self.delta
        if self.reason:
            rec["reason"] = self.reason
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "Event":
        kind = rec.get("event")
        if kind not in EVENT_KINDS:
            raise JournalMismatch(f"unknown timeline event kind {kind!r}")
        ev = cls(
            time=float(rec.get("time", 0.0)),
            kind=kind,
            seq=int(rec.get("seq", 0)),
            pod=rec.get("pod"),
            pod_ref=str(rec.get("podRef") or ""),
            node=rec.get("node"),
            node_name=str(rec.get("nodeName") or ""),
            delta=int(rec.get("delta") or 0),
            reason=str(rec.get("reason") or ""),
        )
        if kind == POD_ARRIVAL and not isinstance(ev.pod, dict):
            raise JournalMismatch("PodArrival event has no pod object")
        if kind == POD_DEPARTURE and not ev.pod_ref:
            raise JournalMismatch("PodDeparture event has no podRef")
        if kind == NODE_JOIN and not isinstance(ev.node, dict):
            raise JournalMismatch("NodeJoin event has no node object")
        if kind in (NODE_DRAIN, SPOT_RECLAIM) and not ev.node_name:
            raise JournalMismatch(f"{kind} event has no nodeName")
        return ev


class EventHeap:
    """Deterministic event priority queue ordered by ``(time, seq)``.

    ``push`` assigns the next ``seq`` when the event has none (seq 0
    and not yet claimed), so same-time events pop in insertion order —
    the autoscaler relies on this when it schedules warm-up NodeJoins
    mid-run. Pop order is a pure function of the pushed sequence:
    identical pushes produce identical traces, byte for byte."""

    def __init__(self, events: Iterable[Event] = ()):
        self._heap: List[Tuple[float, int, Event]] = []
        self._next_seq = 0
        for ev in events:
            self.push(ev)

    def push(self, ev: Event) -> Event:
        if ev.seq == 0 and self._next_seq > 0 or ev.seq < 0:
            ev.seq = self._next_seq
        self._next_seq = max(self._next_seq, ev.seq) + 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Optional[Event]:
        return self._heap[0][2] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def drain(self) -> List[Event]:
        out = []
        while self._heap:
            out.append(self.pop())
        return out


def trace_fingerprint(events: List[Event]) -> str:
    """Digest of a fully-ordered event list — the identity a report or
    journal is keyed on (two generators that emit the same events get
    the same fingerprint, whatever produced them)."""
    return config_fingerprint([ev.as_record() for ev in events])


class TraceWriter:
    """Append-only fsync'd JSONL trace writer (the journal append
    discipline: a crash keeps every event that finished writing).
    ``fsync_each=False`` batches durability to one fsync at close —
    for bulk writes of an already-complete event list, where the
    per-append discipline would pay ~1k fsyncs for nothing (the
    reader tolerates a torn tail either way)."""

    def __init__(self, path: str, fingerprint: str,
                 meta: Optional[dict] = None, fsync_each: bool = True):
        self.path = path
        self.written = 0
        self._fsync_each = fsync_each
        self._f = open(path, "w", encoding="utf-8")
        header = {
            "kind": "header",
            "version": TRACE_VERSION,
            "format": TRACE_FORMAT,
            "fingerprint": fingerprint,
        }
        if meta:
            header["meta"] = meta
        self._emit(header)

    def _emit(self, rec: dict):
        from ..runtime import inject as _inject

        line = json.dumps(rec, separators=(",", ":")) + "\n"
        # chaos crash point (runtime/inject.py): a `crash` clause
        # leaves a durable torn prefix, like a real mid-append death
        _inject.crash_write("journal.fsync.timeline", self._f, line)
        self._f.write(line)
        if self._fsync_each:
            self._f.flush()
            os.fsync(self._f.fileno())

    def append(self, ev: Event):
        self._emit(ev.as_record())
        self.written += 1

    def close(self):
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_trace(path: str, events: List[Event], meta: Optional[dict] = None) -> str:
    """Write a complete event list; returns its fingerprint. One fsync
    at close — the list is complete (and, for synthetic specs,
    regenerable), so the per-append discipline buys nothing here."""
    fp = trace_fingerprint(events)
    with TraceWriter(path, fp, meta=meta, fsync_each=False) as w:
        for ev in events:
            w.append(ev)
    return fp


def read_trace(
    path: str, fingerprint: Optional[str] = None
) -> Tuple[List[Event], dict]:
    """Read a timeline trace: validate the header (and, when given, the
    trace fingerprint — mismatch refuses loudly), replay complete
    records, tolerate a torn final line. Returns ``(events, meta)``
    where meta carries the header plus ``{"dropped": n}``."""
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if not lines or not lines[0].strip():
        raise JournalMismatch(f"{path}: empty timeline trace")
    try:
        header = json.loads(lines[0])
    except ValueError as e:
        raise JournalMismatch(f"{path}: unreadable trace header: {e}") from e
    if not isinstance(header, dict) or header.get("kind") != "header":
        raise JournalMismatch(f"{path}: first record is not a header")
    if header.get("format") != TRACE_FORMAT:
        raise JournalMismatch(
            f"{path}: not a timeline trace (format {header.get('format')!r})"
        )
    if header.get("version") != TRACE_VERSION:
        raise JournalMismatch(
            f"{path}: timeline-trace version {header.get('version')!r} != "
            f"{TRACE_VERSION}"
        )
    if fingerprint is not None and header.get("fingerprint") != fingerprint:
        raise JournalMismatch(
            f"{path}: trace fingerprint {header.get('fingerprint')!r} does "
            f"not match ({fingerprint!r}); refusing to replay a trace "
            "recorded against different inputs"
        )
    body, tail = lines[1:-1], lines[-1]
    events: List[Event] = []
    dropped = 0

    def parse(line: bytes, lineno: int, torn_ok: bool) -> bool:
        try:
            rec = json.loads(line)
        except ValueError as e:
            if torn_ok:
                return False  # torn mid-append: expected damage
            raise JournalMismatch(
                f"{path}: corrupt trace record on line {lineno}: {e}"
            ) from e
        if not isinstance(rec, dict):
            if torn_ok:
                return False
            raise JournalMismatch(
                f"{path}: corrupt trace record on line {lineno}: record "
                "is not an object"
            )
        events.append(Event.from_record(rec))
        return True

    for i, line in enumerate(body):
        if line.strip():
            parse(line, i + 2, torn_ok=False)
    if tail.strip() and not parse(tail, len(lines), torn_ok=True):
        dropped = 1
    # a trace must already be totally ordered: the stepper walks it
    # sequentially and an out-of-order event would silently reorder
    # history (generated traces are ordered by construction)
    for prev, ev in zip(events, events[1:]):
        if ev.key() < prev.key():
            raise JournalMismatch(
                f"{path}: events out of order at seq {ev.seq} "
                f"(t={ev.time} after t={prev.time})"
            )
    meta = dict(header)
    meta["dropped"] = dropped
    return events, meta


# --------------------------------------------------- synthetic traces


def _float64(rng: GoRand) -> float:
    """Go ``Rand.Float64``: Int63 scaled into [0, 1) with the == 1.0
    rejection retry — keeps the synthetic stream on the same
    deterministic Go source every other seeded feature uses."""
    while True:
        f = rng.int63() / (1 << 63)
        if f != 1.0:
            return f


def _exp(rng: GoRand, rate: float) -> float:
    """Exponential(rate) draw via inversion of the Go Float64 stream."""
    return -math.log(1.0 - _float64(rng)) / rate


@dataclass
class SyntheticSpec:
    """Knobs of the seeded synthetic workload.

    ``arrivals`` Poisson pod arrivals at ``arrival_rate`` per second;
    each pod draws a size class (round-robin over ``pod_shapes``) and an
    exponential lifetime with mean ``mean_lifetime_s`` unless it lands
    in the ``long_running_frac`` (no departure). ``spot_frac`` of the
    BASE cluster's nodes (every ``1/spot_frac``-th by index) are spot
    instances, each reclaimed at an Exp(``spot_hazard``) time when that
    falls inside the horizon. All draws come from one seeded Go
    math/rand stream, so a spec + seed IS the trace."""

    arrivals: int = 200
    arrival_rate: float = 1.0  # pods per second
    mean_lifetime_s: float = 120.0
    long_running_frac: float = 0.5
    spot_frac: float = 0.0
    spot_hazard: float = 1.0 / 300.0  # reclaims per second per spot node
    seed: int = 1
    namespace: str = "timeline"
    # (cpu, memory) request shapes, cycled per arrival
    pod_shapes: Tuple[Tuple[str, str], ...] = (
        ("500m", "1Gi"),
        ("1", "2Gi"),
        ("250m", "512Mi"),
        ("2", "4Gi"),
    )

    def as_dict(self) -> dict:
        return {
            "arrivals": self.arrivals,
            "arrivalRate": self.arrival_rate,
            "meanLifetimeS": self.mean_lifetime_s,
            "longRunningFrac": self.long_running_frac,
            "spotFrac": self.spot_frac,
            "spotHazard": self.spot_hazard,
            "seed": self.seed,
        }


def _synthetic_pod(i: int, shape: Tuple[str, str], namespace: str) -> dict:
    cpu, mem = shape
    return {
        "kind": "Pod",
        "metadata": {
            "name": f"tl-pod-{i:05d}",
            "namespace": namespace,
            "labels": {"simon/timeline": "synthetic"},
        },
        "spec": {
            "containers": [
                {
                    "name": "c",
                    "image": "img-timeline",
                    "resources": {"requests": {"cpu": cpu, "memory": mem}},
                }
            ]
        },
    }


def generate_synthetic(
    spec: SyntheticSpec, node_names: Iterable[str] = ()
) -> List[Event]:
    """Deterministic synthetic trace: Poisson arrivals + exponential
    lifetimes + spot-reclaim hazard over the named base nodes. Same
    (spec, node list) -> byte-identical event list
    (tests/test_timeline.py pins this)."""
    rng = GoRand(spec.seed)
    heap = EventHeap()
    t = 0.0
    for i in range(spec.arrivals):
        t += _exp(rng, spec.arrival_rate)
        shape = spec.pod_shapes[i % len(spec.pod_shapes)]
        heap.push(Event(time=t, kind=POD_ARRIVAL,
                        pod=_synthetic_pod(i, shape, spec.namespace)))
        if _float64(rng) >= spec.long_running_frac:
            dep = t + _exp(rng, 1.0 / spec.mean_lifetime_s)
            if dep <= t:  # pragma: no cover - fp underflow guard
                dep = t + 1e-6
            heap.push(Event(
                time=dep, kind=POD_DEPARTURE,
                pod_ref=f"{spec.namespace}/tl-pod-{i:05d}",
                reason="lifetime",
            ))
    horizon = t
    if spec.spot_frac > 0:
        stride = max(int(round(1.0 / spec.spot_frac)), 1)
        for k, name in enumerate(node_names):
            if k % stride:
                continue
            reclaim = _exp(rng, spec.spot_hazard)
            if reclaim <= horizon:
                heap.push(Event(time=reclaim, kind=SPOT_RECLAIM,
                                node_name=name, reason="hazard"))
    events = heap.drain()
    # departures past the horizon stay (capacity still frees inside the
    # trace tail window); seqs are re-stamped in final order so the
    # serialized trace is its own canonical ordering
    for seq, ev in enumerate(events):
        ev.seq = seq
    return events


# --------------------------------------- shadow decision-log converter


def events_from_decision_log(steps) -> List[Event]:
    """Convert shadow decision-log steps (shadow/log.py) into a
    timeline trace: recorded real-cluster history
    replays through what-if policies.

    Mapping (one time unit per step, preserving order):

    - a ``decision`` step's pod becomes a PodArrival — the TIMELINE
      re-decides placement, so the real scheduler's chosen node is
      dropped (that is the point: what would THIS policy have done);
      failed decisions arrive too (the pod wants scheduling);
    - ``place_pod`` deltas (pre-bound arrivals) become PodArrivals that
      keep their ``spec.nodeName`` — original-pin semantics;
    - ``evict_pod`` deltas become PodDepartures;
    - ``add_node`` / ``remove_node`` deltas become NodeJoin/NodeDrain.
    """
    events: List[Event] = []
    t = 0.0
    for step in steps:
        t += 1.0
        for op in step.deltas:
            name = op.get("op")
            if name == "place_pod" and isinstance(op.get("pod"), dict):
                events.append(Event(time=t, kind=POD_ARRIVAL,
                                    pod=op["pod"], reason="prebound"))
            elif name == "evict_pod":
                ref = (f"{op.get('namespace') or 'default'}/"
                       f"{op.get('name') or ''}")
                events.append(Event(time=t, kind=POD_DEPARTURE,
                                    pod_ref=ref, reason="evicted"))
            elif name == "add_node" and isinstance(op.get("node"), dict):
                events.append(Event(time=t, kind=NODE_JOIN,
                                    node=op["node"], reason="churn"))
            elif name == "remove_node":
                events.append(Event(time=t, kind=NODE_DRAIN,
                                    node_name=str(op.get("name") or ""),
                                    reason="churn"))
            else:
                raise JournalMismatch(
                    f"decision-log delta op {name!r} has no timeline mapping"
                )
        if step.kind == "decision" and isinstance(step.pod, dict):
            pod = dict(step.pod)
            # the decision pod is UNSCHEDULED by the log contract; any
            # stray binding must not become an original pin here
            if isinstance(pod.get("spec"), dict) and pod["spec"].get("nodeName"):
                pod["spec"] = {
                    k: v for k, v in pod["spec"].items() if k != "nodeName"
                }
            events.append(Event(time=t, kind=POD_ARRIVAL, pod=pod,
                                reason="decision"))
    for seq, ev in enumerate(events):
        ev.seq = seq
    return events
