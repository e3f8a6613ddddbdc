"""The cluster-delta substrate: one typed vocabulary of live-cluster
state changes and ONE incremental applicator that keeps a warm mirror
current (the port's copy of the JAX package's twin/deltas.py).

The shadow replayer's decision-log delta ops (shadow/log.py) and the
timeline's event stream (timeline/events.py) share this floor:

- ``ClusterDelta`` — six kinds: ``node_join`` / ``node_drain`` (node
  churn), ``pod_bind`` / ``pod_evict`` (scheduled capacity changes),
  ``pod_arrive`` / ``pod_delete`` (pending-queue changes). JSON
  round-trip (``as_record``/``from_record``), lossless conversion
  from the shadow decision-log op dialect (``from_shadow_op``) and to
  timeline events (``deltas_to_events``).

- ``MirrorApplicator`` — mutates a warm ``Oracle`` (and, on the cuda
  engine, its ``TorchEngine``) IN PLACE, one delta at a time: a
  ``pod_bind`` is one incremental ``place_existing_pod`` on a
  copy-on-write ``NodeState``, a ``pod_evict`` one ``evict_pod``, a
  ``node_join`` one ``add_node`` — never a cluster reload, and never
  a re-encode of anything but the affected state. A probe after a pod
  delta launches the already-built kernel library again: warm deltas
  cost zero nvcc builds (``nvcc_builds_total``, obs/profile.py). The
  ONE exception is ``node_drain``: node identity is baked into every
  index and encoding, so a drain is a counted state rebuild from the
  survivors (``twin_delta_reloads_total`` — the same rule the shadow
  replayer has for ``remove_node``).

- conformance machinery — ``materialize`` folds a delta stream into
  the cold-reload form (final nodes, bound pods in bind order,
  pending pods), ``cold_reload`` builds a fresh applicator from it,
  and ``state_dict`` canonicalizes an applicator's full capacity
  state (per-node pods, request totals, scalars, ports, GPU devices,
  storage VGs, plus the pending queue). The substrate's contract —
  applying any recorded delta stream to a warm mirror is dict-equal
  to a cold reload of the resulting cluster — is an equality between
  two ``state_dict`` values. (Commit-sequence numbers are deliberately
  outside the canonical state: they encode arrival history, which a
  cold reload of the *resulting* cluster does not have.)

Consumers: the shadow replayer (shadow/replay.py), the twin mirror
(twin/mirror.py) and queries (twin/queries.py), the serve session's
pushed deltas (``POST /v1/cluster-delta``, serve/session.py) and the
timeline's event stream (``deltas_to_events``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..models.validation import InputError
from ..utils.trace import COUNTERS

NODE_JOIN = "node_join"
NODE_DRAIN = "node_drain"
POD_BIND = "pod_bind"
POD_EVICT = "pod_evict"
POD_ARRIVE = "pod_arrive"
POD_DELETE = "pod_delete"

DELTA_KINDS = (NODE_JOIN, NODE_DRAIN, POD_BIND, POD_EVICT, POD_ARRIVE, POD_DELETE)

#: apply() outcomes (callers map them onto their own counters)
APPLIED = "applied"
SKIPPED = "skipped"
RELOADED = "reloaded"


def _pod_key(pod: dict) -> Tuple[str, str]:
    meta = (pod or {}).get("metadata") or {}
    return (meta.get("namespace") or "default", meta.get("name", ""))


def _own_pod(p: dict) -> dict:
    """Shallow-clone a pod's mutation surface (bind writes
    spec.nodeName / status / metadata.annotations) so applying a delta
    never pollutes the caller's record objects."""
    q = dict(p)
    q["spec"] = dict(p.get("spec") or {})
    meta = dict(p.get("metadata") or {})
    if meta.get("annotations") is not None:
        meta["annotations"] = dict(meta["annotations"])
    q["metadata"] = meta
    if isinstance(q.get("status"), dict):
        q["status"] = dict(q["status"])
    return q


@dataclass
class ClusterDelta:
    """One observed cluster state change.

    ``pod_bind`` carries the pod in its UNBOUND form plus the node the
    scheduler chose (``node_name``) — the applicator writes the
    binding; ``pod_arrive`` carries an unbound pod entering the
    pending queue; ``pod_evict`` / ``pod_delete`` reference pods by
    namespace/name (``pod_evict`` also names the node for a targeted
    walk). ``node_join`` carries the node object, ``node_drain`` its
    name."""

    kind: str
    pod: Optional[dict] = None
    node: Optional[dict] = None
    node_name: str = ""
    namespace: str = "default"
    name: str = ""

    def __post_init__(self):
        if self.kind not in DELTA_KINDS:
            raise InputError(f"unknown cluster-delta kind {self.kind!r}")
        if self.kind in (POD_BIND, POD_ARRIVE):
            if not isinstance(self.pod, dict):
                raise InputError(f"{self.kind} delta has no pod object")
            ns, name = _pod_key(self.pod)
            if not name:
                raise InputError(f"{self.kind} delta pod has no metadata.name")
            self.namespace, self.name = ns, name
        if self.kind == POD_ARRIVE and (self.pod.get("spec") or {}).get("nodeName"):
            raise InputError(
                "pod_arrive delta pod carries spec.nodeName — a bound "
                "arrival is a pod_bind delta"
            )
        if self.kind == POD_BIND and not self.node_name:
            raise InputError("pod_bind delta has no node_name")
        if self.kind == NODE_JOIN:
            if not isinstance(self.node, dict):
                raise InputError("node_join delta has no node object")
            self.node_name = (self.node.get("metadata") or {}).get("name") or ""
            if not self.node_name:
                raise InputError("node_join delta node has no metadata.name")
        if self.kind == NODE_DRAIN and not self.node_name:
            raise InputError("node_drain delta has no node_name")
        if self.kind in (POD_EVICT, POD_DELETE) and not self.name:
            raise InputError(f"{self.kind} delta has no pod name")

    @property
    def pod_key(self) -> Tuple[str, str]:
        return (self.namespace, self.name)

    def as_record(self) -> dict:
        rec: dict = {"kind": self.kind}
        if self.kind in (POD_BIND, POD_ARRIVE):
            rec["pod"] = self.pod
            if self.kind == POD_BIND:
                rec["node"] = self.node_name
        elif self.kind in (POD_EVICT, POD_DELETE):
            rec["namespace"] = self.namespace
            rec["name"] = self.name
            if self.node_name:
                rec["node"] = self.node_name
        elif self.kind == NODE_JOIN:
            rec["node"] = self.node
        else:  # node_drain
            rec["name"] = self.node_name
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "ClusterDelta":
        if not isinstance(rec, dict):
            raise InputError("cluster-delta record is not an object")
        kind = rec.get("kind")
        if kind in (POD_BIND, POD_ARRIVE):
            return cls(kind=kind, pod=rec.get("pod"),
                       node_name=str(rec.get("node") or ""))
        if kind in (POD_EVICT, POD_DELETE):
            return cls(
                kind=kind,
                namespace=str(rec.get("namespace") or "default"),
                name=str(rec.get("name") or ""),
                node_name=str(rec.get("node") or ""),
            )
        if kind == NODE_JOIN:
            return cls(kind=kind, node=rec.get("node"))
        if kind == NODE_DRAIN:
            return cls(kind=kind, node_name=str(rec.get("name") or ""))
        raise InputError(f"unknown cluster-delta kind {kind!r}")


# -- the shadow decision-log dialect ------------------------------------


def from_shadow_op(op: dict) -> ClusterDelta:
    """One decision-log delta op (shadow/log.py vocabulary) as a
    ClusterDelta. ``place_pod`` splits into pod + node (the pod object
    keeps its recorded form; the applicator re-owns it)."""
    kind = op.get("op")
    if kind == "place_pod":
        pod = op.get("pod") or {}
        node = (pod.get("spec") or {}).get("nodeName") or ""
        unbound = _own_pod(pod)
        unbound["spec"].pop("nodeName", None)
        return ClusterDelta(kind=POD_BIND, pod=unbound, node_name=node)
    if kind == "evict_pod":
        return ClusterDelta(
            kind=POD_EVICT,
            namespace=str(op.get("namespace") or "default"),
            name=str(op.get("name") or ""),
            node_name=str(op.get("node") or ""),
        )
    if kind == "add_node":
        return ClusterDelta(kind=NODE_JOIN, node=op.get("node"))
    if kind == "remove_node":
        return ClusterDelta(kind=NODE_DRAIN, node_name=str(op.get("name") or ""))
    raise InputError(f"unknown delta op {kind!r}")


def steps_to_deltas(steps) -> List[ClusterDelta]:
    """A decision-log step stream folded into pure state deltas: each
    step's delta ops convert 1:1; a decision step becomes the state
    change it caused (``pod_bind`` when the real scheduler placed the
    pod, ``pod_arrive`` when it failed — the pod exists, pending).
    This is the stream the conformance gate replays both warm and
    cold."""
    out: List[ClusterDelta] = []
    for st in steps:
        for op in st.deltas:
            out.append(from_shadow_op(op))
        if st.kind == "decision":
            if st.node:
                out.append(
                    ClusterDelta(kind=POD_BIND, pod=st.pod, node_name=st.node)
                )
            else:
                out.append(ClusterDelta(kind=POD_ARRIVE, pod=st.pod))
    return out


def deltas_to_events(
    deltas: List[ClusterDelta], t0: float = 0.0, spacing: float = 1.0
) -> list:
    """A delta stream as timeline events (timeline/events.py), spaced
    ``spacing`` seconds apart from ``t0`` — the bridge that lets
    timeline windows step forward over recorded or mirrored delta
    streams (the twin forecast seeds its pending queue through this;
    bound pods arrive pinned via their spec.nodeName)."""
    from ..timeline import events as tev

    out = []
    t = t0
    for i, d in enumerate(deltas):
        if d.kind == POD_ARRIVE:
            out.append(tev.Event(time=t, kind=tev.POD_ARRIVAL, seq=i,
                                 pod=copy.deepcopy(d.pod)))
        elif d.kind == POD_BIND:
            pod = _own_pod(d.pod)
            pod["spec"]["nodeName"] = d.node_name
            out.append(tev.Event(time=t, kind=tev.POD_ARRIVAL, seq=i, pod=pod))
        elif d.kind in (POD_EVICT, POD_DELETE):
            out.append(tev.Event(
                time=t, kind=tev.POD_DEPARTURE, seq=i,
                pod_ref=f"{d.namespace}/{d.name}",
            ))
        elif d.kind == NODE_JOIN:
            out.append(tev.Event(time=t, kind=tev.NODE_JOIN, seq=i,
                                 node=copy.deepcopy(d.node)))
        else:  # node_drain
            out.append(tev.Event(time=t, kind=tev.NODE_DRAIN, seq=i,
                                 node_name=d.node_name))
        t += spacing
    return out


# -- the incremental applicator -----------------------------------------


class MirrorApplicator:
    """Owns one warm Oracle (+ a TorchEngine on the cuda engine) and the
    pending-pod queue, and applies ClusterDeltas to them in place.

    The applicator is the ONLY mutation path of a mirrored cluster:
    the shadow replayer, the twin mirror, and the conformance gate all
    route through ``apply``, so the application semantics cannot fork
    per subsystem. ``apply`` returns APPLIED / SKIPPED / RELOADED —
    SKIPPED covers the live-tail races a resident mirror must survive
    (a bind naming a node the mirror never saw, an evict for a pod
    already gone), counted, never fatal."""

    def __init__(self, cluster, engine: str = "cuda", device=None):
        if engine not in ("cuda", "oracle"):
            raise InputError(f"unknown mirror engine {engine!r}")
        self.cluster = cluster
        self.engine_kind = engine
        # the probe scans' device: the card unless the caller names
        # another, resolved up front so a missing card fails before any
        # work (the oracle engine has no device state)
        if engine == "cuda":
            from ..ops.fused_scan import resolve_device

            device = resolve_device(device)
        self.device = device
        self.reloads = 0
        self.skips = 0
        self.applied = 0
        #: pending (observed-but-unbound) pods, insertion-ordered
        self.pending: "Dict[Tuple[str, str], dict]" = {}
        #: bound pods by key -> node name (re-bind = evict + place)
        self._bound: Dict[Tuple[str, str], str] = {}
        self._build(list(cluster.nodes))

    def _build(self, nodes: List[dict]):
        from ..scheduler.oracle import Oracle

        self.oracle = Oracle(
            nodes,
            pdbs=self.cluster.pod_disruption_budgets,
            priority_classes=self.cluster.priority_classes,
        )
        self.engine = None
        if self.engine_kind == "cuda":
            from ..scheduler.engine import TorchEngine

            self.engine = TorchEngine(self.oracle, device=self.device)

    # -- application -------------------------------------------------------

    def apply(self, delta: ClusterDelta) -> str:
        """Apply one delta; returns APPLIED, SKIPPED, or RELOADED."""
        from ..runtime import inject as _inject

        # chaos seam (runtime/inject.py): a fault here lands exactly
        # where a torn feed or corrupt record would
        _inject.fire("twin.apply_delta", kind=delta.kind)
        out = self._apply(delta)
        COUNTERS.inc(f"twin_delta_{delta.kind}_total")
        if out == SKIPPED:
            self.skips += 1
            COUNTERS.inc("twin_delta_skips_total")
        else:
            self.applied += 1
            COUNTERS.inc("twin_deltas_applied_total")
            if out == RELOADED:
                self.reloads += 1
                COUNTERS.inc("twin_delta_reloads_total")
        return out

    def _apply(self, delta: ClusterDelta) -> str:
        kind = delta.kind
        if kind == POD_BIND:
            return self._bind(delta)
        if kind == POD_EVICT:
            return self._evict(delta.pod_key, delta.node_name or None)
        if kind == POD_ARRIVE:
            self.pending[delta.pod_key] = _own_pod(delta.pod)
            return APPLIED
        if kind == POD_DELETE:
            if self.pending.pop(delta.pod_key, None) is None:
                return SKIPPED
            return APPLIED
        if kind == NODE_JOIN:
            if delta.node_name in self.oracle.node_index:
                return SKIPPED  # re-join of a known node
            self.oracle.add_node(delta.node)
            return APPLIED
        # node_drain
        return self._drain(delta.node_name)

    def _bind(self, delta: ClusterDelta) -> str:
        oracle = self.oracle
        if delta.node_name not in oracle.node_index:
            # bound to a node the mirror never saw (live-tail race /
            # dangling pre-bind): tracked by the apiserver only, never
            # by the scheduler — skip, counted
            return SKIPPED
        key = delta.pod_key
        if key in self._bound:
            # a re-bind of a live key (delete+recreate collapsed into
            # one poll): evict the stale binding first
            self._evict(key, self._bound.get(key))
        pod = _own_pod(delta.pod)
        pod["spec"]["nodeName"] = delta.node_name
        oracle.place_existing_pod(pod)
        self._bound[key] = delta.node_name
        self.pending.pop(key, None)
        return APPLIED

    def _evict(self, key: Tuple[str, str], node_name: Optional[str]) -> str:
        # an evict can also target a PENDING pod (a failed-then-deleted
        # pod disappearing from the tail): removal from the queue is a
        # real application, not a skip
        if key not in self._bound and self.pending.pop(key, None) is not None:
            return APPLIED
        oracle = self.oracle
        # the named node first (the common case), then the bound index,
        # then a full walk: a live tail can name a STALE node (the pod
        # rebound within one poll window) and the cold-reload side
        # drops the pod unconditionally — the warm side must find it
        # wherever it actually sits or conformance forks
        names = []
        for cand in (node_name, self._bound.get(key)):
            if cand and cand not in names:
                names.append(cand)
        names.extend(n for n in oracle.node_index if n not in names)
        for name in names:
            idx = oracle.node_index.get(name or "")
            if idx is None:
                continue
            ns = oracle.nodes[idx]
            for p in ns.pods:
                if _pod_key(p) == key:
                    oracle.evict_pod(ns, p)
                    self._bound.pop(key, None)
                    return APPLIED
        return SKIPPED

    def _drain(self, name: str) -> str:
        """Node identity is baked into every index and encoding, so a
        drain is the one delta that rebuilds: survivors re-place their
        committed pods on a fresh oracle (pods of the drained node die
        with it). Counted — the cost is visible, never hidden."""
        oracle = self.oracle
        if name not in oracle.node_index:
            raise InputError(f"node_drain delta names unknown node {name!r}")
        survivors = [ns for ns in oracle.nodes if ns.name != name]
        nodes = [ns.node for ns in survivors]
        committed = [p for ns in survivors for p in ns.pods]
        self._build(nodes)
        self._bound = {
            k: n for k, n in self._bound.items() if n != name
        }
        for p in committed:
            self.oracle.place_existing_pod(p)
        return RELOADED

    # -- decision integration ----------------------------------------------

    def commit_decision(self, pod: dict, node_idx: int) -> None:
        """Commit a REAL scheduler decision into the mirror (the
        replayer's commit-reality path): the same binding code the
        serial engine uses, with the bound-key index updated so later
        deltas referencing this pod resolve incrementally."""
        from ..runtime import inject as _inject

        # chaos seam: a decision commit IS a pod_bind delta in
        # substrate terms — same fault surface as apply()
        _inject.fire("twin.apply_delta", kind="decision_commit")
        if self.engine is not None:
            self.engine.commit_host(pod, node_idx)
        else:
            self.oracle._reserve_and_bind(pod, self.oracle.nodes[int(node_idx)])
        key = _pod_key(pod)
        self._bound[key] = self.oracle.nodes[int(node_idx)].name
        self.pending.pop(key, None)

    def note_pending(self, pod: dict) -> None:
        """Track a pod the real scheduler FAILED to place: it exists,
        pending — the population the twin's capacity forecast requeues
        (queries.py)."""
        self.pending[_pod_key(pod)] = _own_pod(pod)

    # -- canonical state ---------------------------------------------------

    def state_dict(self) -> dict:
        return state_dict(self)


def state_dict(app: MirrorApplicator) -> dict:
    """Canonical capacity state of a mirrored cluster: everything the
    scheduler reads when it filters and scores, in a deterministic
    JSON-able form. Two mirrors with equal state_dicts answer every
    what-if question identically — this equality IS the delta-vs-cold-
    reload conformance contract."""
    from ..models import storage as stor

    nodes = {}
    for ns in app.oracle.nodes:
        entry: dict = {
            "pods": sorted(
                "%s/%s" % _pod_key(p) for p in ns.pods
            ),
            "mcpu": ns.req_mcpu,
            "mem": ns.req_mem,
            "eph": ns.req_eph,
            "floorMcpu": ns.req_floor_mcpu,
            "floorMem": ns.req_floor_mem,
            "nzMcpu": ns.nz_mcpu,
            "nzMem": ns.nz_mem,
            "scalars": {k: v for k, v in sorted(ns.req_scalar.items()) if v},
            "ports": sorted(list(t) for t in ns.used_ports),
        }
        if ns.gpu is not None:
            entry["gpu"] = {
                "used": list(ns.gpu.used),
                "allocatable": ns.gpu.allocatable_count(),
                "gpuCount": ns.alloc_int(stor.GPU_COUNT_ANNO),
            }
        if ns.storage is not None:
            entry["storage"] = {
                "vgs": [int(vg.requested) for vg in ns.storage.vgs],
                "devices": [bool(d.is_allocated) for d in ns.storage.devices],
            }
        nodes[ns.name] = entry
    return {
        "nodes": nodes,
        "pending": sorted("%s/%s" % k for k in app.pending),
    }


# -- cold-reload conformance --------------------------------------------


@dataclass
class Materialized:
    """The cold-reload form of (base cluster, delta stream): the final
    node list, the bound pods in bind order (each carrying its
    spec.nodeName), and the still-pending pods."""

    nodes: List[dict] = field(default_factory=list)
    bound: List[dict] = field(default_factory=list)
    pending: List[dict] = field(default_factory=list)


def materialize(base_nodes: List[dict], deltas: List[ClusterDelta]) -> Materialized:
    """Fold a delta stream over a base node list into the resulting
    cluster — the input a cold full reload would load. Mirrors the
    applicator's skip semantics exactly (a bind to a never-seen node
    is dropped in both; pods of a drained node die with it), so warm
    and cold diverge only if the applicator has a bug."""
    nodes: "Dict[str, dict]" = {}
    for n in base_nodes:
        name = (n.get("metadata") or {}).get("name", "")
        nodes[name] = n
    bound: "Dict[Tuple[str, str], dict]" = {}
    pending: "Dict[Tuple[str, str], dict]" = {}
    for d in deltas:
        if d.kind == NODE_JOIN:
            nodes.setdefault(d.node_name, d.node)
        elif d.kind == NODE_DRAIN:
            if d.node_name not in nodes:
                raise InputError(
                    f"node_drain delta names unknown node {d.node_name!r}"
                )
            nodes.pop(d.node_name)
            for key in [
                k for k, p in bound.items()
                if (p.get("spec") or {}).get("nodeName") == d.node_name
            ]:
                bound.pop(key)
        elif d.kind == POD_BIND:
            if d.node_name not in nodes:
                continue  # the applicator's counted skip
            pod = _own_pod(d.pod)
            pod["spec"]["nodeName"] = d.node_name
            # rebind: drop the stale entry so bind ORDER stays the
            # replay order of the surviving binding
            bound.pop(d.pod_key, None)
            bound[d.pod_key] = pod
            pending.pop(d.pod_key, None)
        elif d.kind == POD_EVICT:
            if bound.pop(d.pod_key, None) is None:
                pending.pop(d.pod_key, None)
        elif d.kind == POD_ARRIVE:
            pending[d.pod_key] = _own_pod(d.pod)
        else:  # pod_delete
            pending.pop(d.pod_key, None)
    return Materialized(
        nodes=list(nodes.values()),
        bound=list(bound.values()),
        pending=list(pending.values()),
    )


def cold_reload(cluster, deltas: List[ClusterDelta], engine: str = "oracle") -> MirrorApplicator:
    """Build the ground-truth applicator: a fresh Oracle over the
    materialized node list, every surviving bound pod placed in bind
    order, the pending queue rebuilt. ``state_dict(cold_reload(...))``
    is what a warm mirror must equal after applying the same stream."""
    m = materialize(cluster.nodes, deltas)
    cold_cluster = cluster.copy()
    cold_cluster.nodes = m.nodes
    app = MirrorApplicator(cold_cluster, engine=engine)
    for pod in m.bound:
        # deep-own: place_existing_pod may stamp GPU annotations
        p = _own_pod(pod)
        app.oracle.place_existing_pod(p)
        app._bound[_pod_key(p)] = (p.get("spec") or {}).get("nodeName") or ""
    for pod in m.pending:
        app.pending[_pod_key(pod)] = _own_pod(pod)
    return app
