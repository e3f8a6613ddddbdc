"""Delta re-simulation: a placement-journal prefix index over the
committed scan.

The port's copy of the JAX package's incremental/resim.py. The roster's
scan and each suffix re-simulation run through the cuda engine on the
scan's ``device`` (the card unless the caller names another): one
single-scan kernel launch (B1, or the instantiation the plan needs) per
scan. ``state_digest()`` is equal across the two packages on the same
roster.

A warm serve session answers what-if requests against a cluster whose
committed pods change rarely and by a handful at a time — yet every
tick used to re-scan the WHOLE roster (cluster pods active in every
scenario row). This module keeps the committed placements as a
resident journal:

- ``CommittedScan`` runs the roster through the existing engine path
  ONCE (``scheduler/core.Simulator._schedule_pods`` — the same
  begin_batch / scan_active / replay machinery as a standalone
  ``simulate()``), keeps the resulting oracle WARM, and records a
  per-pod journal row: how each roster position committed (bulk-simple
  / pinned / failed / dangling / side-effect) plus the node name and
  the per-class RequestSummary tables of the bulk replay.
- What-if requests then dispatch ONLY their own pods (the suffix)
  against the committed oracle's dynamic state — the sequential-commit
  property makes this placement-identical to scanning cluster + request
  pods from scratch (exactly the multi-app contract of
  ``schedule_app``), and the serve conformance gates assert the bytes.
- A ``ClusterDelta`` re-simulates only the journal SUFFIX that its
  conservative dependency rule (``suffix_for_delta``) says could
  change: the prefix replays host-side from the journal (bulk
  scatter-add commits, no device work, no re-encode), and one
  suffix-sized scan re-decides the rest. Placements are byte-identical
  to a full re-scan (conformance-gated over seeded random delta
  streams, tests/test_incremental.py).

Conservatism (the suffix rule table, docs/PERFORMANCE.md): priority
tiers / preemption and side-effectful plugin classes (gpushare,
open-local storage, extenders) force the FULL suffix — their commit
order couples arbitrary positions, so "could change" is everything.
The rule is allowed to widen, never to narrow: a wrong-but-wide suffix
costs time, a wrong-but-narrow one would cost correctness.

The ``incremental.suffix`` chaos seam lives at the head of every
re-simulation; classified faults degrade to the full re-scan with
identical results (tests/test_chaos_matrix.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..runtime import inject as _inject
from ..utils.trace import COUNTERS

# journal codes: how a roster position committed
S_BULK = 0      # simple class, bulk-replayable (scatter-add)
S_PINNED = 1    # spec.nodeName pin to a known node (place_existing_pod)
S_FAILED = 2    # unschedulable; reason cached at its own step state
S_DANGLING = 3  # pinned to an unknown node; tracked, never scheduled
S_SIDE = 4      # placed through a side-effect class (GPU/storage/…)

_CODE_NAMES = {
    S_BULK: "bulk", S_PINNED: "pinned", S_FAILED: "failed",
    S_DANGLING: "dangling", S_SIDE: "side-effect",
}


def own_pod(p: dict) -> dict:
    """Shallow-clone the mutation surface of a pod dict (bind writes
    spec.nodeName / status.phase / metadata.annotations) — the serve
    Session idiom: roster dicts stay pristine for later encodes."""
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
class SuffixDecision:
    """Where re-simulation must begin. ``start == roster_len`` means
    nothing needs re-deciding; ``full`` forces position 0 with the
    journal prefix discarded."""

    start: int
    full: bool
    reason: str

    @property
    def trivial(self) -> bool:
        return not self.full and self.start < 0


def suffix_for_delta(
    kind: str,
    roster_len: int,
    *,
    positions=(),
    insert_position: Optional[int] = None,
    has_priority: bool = False,
    has_side_effects: bool = False,
) -> SuffixDecision:
    """The conservative dependency rule: given a delta's kind and the
    roster positions it touches, the earliest journal position whose
    feasible-node set or queue order could change.

    ============  =========================================================
    delta          suffix
    ============  =========================================================
    pod_evict /    from the evicted position — earlier pods committed
    pod_delete     against state the eviction cannot reach
    pod_arrive /   from the insertion position (min with the replaced
    pod_bind       position on re-arrival of a live key)
    node_drain     from the first position journaled ONTO a drained node
                   (losing a non-chosen node never flips an earlier
                   first-max winner); callers with daemonsets reload
                   the whole session instead (roster itself changes)
    node_join      FULL — any pod could have preferred the new node
    any, when the  FULL — priority tiers / preemption couple arbitrary
    roster carries positions; side-effect classes (gpushare, storage,
    priority or    extenders) thread allocator state through commit
    side effects   order
    ============  =========================================================
    """
    if has_priority:
        return SuffixDecision(0, True, "priority tiers force the full suffix")
    if has_side_effects:
        return SuffixDecision(
            0, True, "side-effect classes force the full suffix"
        )
    if kind == "node_join":
        return SuffixDecision(0, True, "node_join: any pod could prefer it")
    touched = [int(p) for p in positions if p is not None and p >= 0]
    if insert_position is not None:
        touched.append(int(insert_position))
    if not touched:
        return SuffixDecision(-1, False, f"{kind}: no journal position touched")
    start = min(touched)
    if start <= 0:
        return SuffixDecision(0, True, f"{kind}: suffix is the whole journal")
    return SuffixDecision(min(start, roster_len), False, f"{kind}")


class CommittedScan:
    """The committed roster, scanned once and kept warm: a resident
    oracle + engine over the committed state, the per-position journal,
    and the bulk-commit tables that make prefix replay a scatter-add
    instead of a re-scan. ``device`` is the scans' device: the card
    unless the caller names another (``fused_scan.resolve_device``)."""

    def __init__(self, nodes: List[dict], roster: List[dict], device=None,
                 _prefix_from: Optional["CommittedScan"] = None,
                 _prefix_len: int = 0):
        from ..ops.fused_scan import resolve_device
        from ..utils.trace import phase

        self.nodes = nodes
        self.device = resolve_device(device)
        self.total = len(roster)
        self.codes = np.zeros(self.total, dtype=np.int8)
        self.node_names: List[Optional[str]] = [None] * self.total
        self.reasons: Dict[int, str] = {}
        self.cls_rows = np.full(self.total, -1, dtype=np.int64)
        self.failed = []  # UnscheduledPod, roster order
        # grown per-class commit tables (the bulk replay's vocabulary);
        # suffix re-simulations append their batch's classes
        self.field_tbl = np.zeros((0, 7), dtype=np.int64)
        self.ports_of: list = []
        self.scalars_of: list = []
        # priority/preemption couple commit order to arbitrary earlier
        # positions (evicted victims requeue): a scan that saw either
        # can never seed a positional prefix replay
        self._ordering_coupled = False
        with phase("incremental/committed-scan"):
            self._build(roster, _prefix_from, _prefix_len)

    # -- construction --------------------------------------------------------

    def _build(self, roster, prefix_from, prefix_len):
        from ..scheduler.oracle import Oracle

        oracle = Oracle(self.nodes)
        start = 0
        if prefix_from is not None and prefix_len > 0:
            self._replay_prefix(oracle, roster, prefix_from, prefix_len)
            start = prefix_len
        self.oracle = oracle
        self.engine = self._scan_suffix(roster, start)
        COUNTERS.gauge("incremental_committed_pods", float(self.total))

    def _replay_prefix(self, oracle, roster, prev: "CommittedScan", n: int):
        """Host-only replay of journal positions [0, n) — the reused
        prefix: bulk scatter-add for simple runs, per-pod paths for
        pins and the cached failure reasons. No encode, no dispatch."""
        from ..scheduler.core import UnscheduledPod

        # COMPACT the inherited class tables to the rows the prefix
        # actually references: chained re-simulations would otherwise
        # grow field_tbl/ports_of/scalars_of by every suffix batch's
        # classes forever (a resident daemon on a steady delta stream
        # never full-rebuilds), leaking memory and making the vstack
        # per delta progressively slower
        codes = prev.codes[:n]
        old_rows = prev.cls_rows[:n]
        used = np.unique(old_rows[old_rows >= 0])
        if len(used):
            remap = np.full(int(used[-1]) + 1, -1, dtype=np.int64)
            remap[used] = np.arange(len(used))
            self.field_tbl = prev.field_tbl[used]
            self.ports_of = [prev.ports_of[int(o)] for o in used.tolist()]
            self.scalars_of = [
                prev.scalars_of[int(o)] for o in used.tolist()
            ]
            self.cls_rows[:n] = np.where(
                old_rows >= 0, remap[np.clip(old_rows, 0, None)], -1
            )
        self.codes[:n] = codes
        self.node_names[:n] = prev.node_names[:n]
        copies = [own_pod(roster[i]) for i in range(n)]
        node_index = oracle.node_index

        def bulk(a, b):
            if b <= a:
                return
            idx = np.fromiter(
                (node_index[self.node_names[i]] for i in range(a, b)),
                dtype=np.int64, count=b - a,
            )
            oracle.commit_simple_bulk(
                copies[a:b], idx, self.cls_rows[a:b],
                self.field_tbl, self.ports_of, self.scalars_of,
            )

        prev_i = 0
        for e in np.flatnonzero(codes != S_BULK).tolist():
            bulk(prev_i, e)
            prev_i = e + 1
            pod, code = copies[e], int(codes[e])
            if code == S_PINNED:
                oracle.place_existing_pod(pod)
            elif code == S_FAILED:
                self.reasons[e] = prev.reasons[e]
                self.failed.append(
                    UnscheduledPod(pod=pod, reason=prev.reasons[e])
                )
            elif code == S_DANGLING:
                pass  # tracked, never scheduled, absent from node status
            else:  # S_SIDE in a prefix replay: the caller's rule is wrong
                from ..runtime.errors import ConformanceError

                raise ConformanceError(
                    "side-effect journal entry inside a reused prefix — "
                    "suffix_for_delta must force the full suffix"
                )
        bulk(prev_i, n)
        COUNTERS.inc("incremental_prefix_reused_pods_total", n)

    def _scan_suffix(self, roster, start: int):
        """Scan roster[start:] through the real engine path against the
        oracle's current (prefix) state, then journal how every
        position committed. Returns the warm engine."""
        from ..scheduler.core import Simulator
        from ..scheduler.engine import TorchEngine

        suffix = [own_pod(p) for p in roster[start:]]
        sim = Simulator(engine="cuda", device=self.device)
        sim.oracle = self.oracle
        result = sim._schedule_pods(suffix, build_status=False)
        if result.preemptions or self.oracle.saw_priority:
            self._ordering_coupled = True
        COUNTERS.inc("incremental_suffix_pods_total", len(suffix))
        engine = sim._engine
        self._journal_window(roster, start, suffix, result, engine)
        if engine is None or engine.oracle is not self.oracle:
            engine = TorchEngine(self.oracle, device=self.device)
        return engine

    def _journal_window(self, roster, start, copies, result, engine):
        """Fill journal rows [start, start+len(copies)) from the commit
        outcome: the bound copies carry their node, the engine batch
        carries the class vocabulary for later bulk replays."""
        from ..scheduler.engine import build_bulk_tables

        failed_by_id = {id(up.pod): up for up in result.unscheduled_pods}
        self.failed.extend(result.unscheduled_pods)
        node_index = self.oracle.node_index
        cls_of = simple = bulk_ok = None
        offset = len(self.ports_of)
        if engine is not None and engine._batch is not None:
            cls_of = np.asarray(engine._last_class_of)
            simple = engine._last_simple
            field_tbl, ports_of, scalars_of, bulk_ok = build_bulk_tables(
                engine._batch, simple
            )
            self.field_tbl = (
                np.vstack([self.field_tbl, field_tbl])
                if len(self.field_tbl)
                else field_tbl
            )
            self.ports_of = list(self.ports_of) + list(ports_of)
            self.scalars_of = list(self.scalars_of) + list(scalars_of)
        # the engine batch covers the NON-dangling window pods in
        # order (core._scan_and_commit's pos_of contract), so walking
        # the copies while skipping dangling entries recovers each
        # pod's batch position — and with it its class row
        batch_pos = 0
        for k, pod in enumerate(copies):
            i = start + k
            up = failed_by_id.get(id(pod))
            name = (pod.get("spec") or {}).get("nodeName")
            pinned = bool((roster[i].get("spec") or {}).get("nodeName"))
            if name and name not in node_index:
                self.codes[i] = S_DANGLING
                self.node_names[i] = name
                continue  # dangling pods never entered the batch
            if up is not None:
                self.codes[i] = S_FAILED
                self.reasons[i] = up.reason
                batch_pos += 1
                continue
            self.node_names[i] = name
            if pinned:
                self.codes[i] = S_PINNED
            elif not name:
                # a non-failed, non-pinned pod with no binding —
                # unreachable by the commit contract; journal it as a
                # side-effect row so any later delta takes the full path
                self.codes[i] = S_SIDE
            elif cls_of is not None and batch_pos < len(cls_of):
                cls = int(cls_of[batch_pos])
                if simple[cls] and bulk_ok[cls]:
                    self.codes[i] = S_BULK
                    self.cls_rows[i] = offset + cls
                else:
                    self.codes[i] = S_SIDE
            else:
                self.codes[i] = S_SIDE
            batch_pos += 1

    # -- properties ----------------------------------------------------------

    @property
    def bulk_eligible(self) -> bool:
        """Whether the journal can seed a prefix replay: no
        side-effect rows (their commits thread allocator state the
        scatter-add cannot reproduce) and no priority/preemption
        ordering coupling (victims requeue out of roster order)."""
        return not self._ordering_coupled and not bool(
            (self.codes == S_SIDE).any()
        )

    @property
    def has_failures(self) -> bool:
        return bool(self.failed)

    # -- delta re-simulation -------------------------------------------------

    def resimulate(self, roster: List[dict], start: int) -> "CommittedScan":
        """Re-simulate journal positions [start, len(roster)) against
        the reused prefix; returns the NEW committed scan (self is
        untouched — the caller swaps on success). The chaos seam
        ``incremental.suffix`` fires here; the session degrades
        classified faults to :meth:`rebuild`."""
        _inject.fire("incremental.suffix", start=start)
        lied = _inject.value("incremental.suffix")
        if lied is not None or not self.bulk_eligible or start <= 0:
            reason = (
                "injected suffix lie distrusted"
                if lied is not None
                else ("side-effect journal rows" if not self.bulk_eligible
                      else "suffix is the whole journal")
            )
            from ..utils.trace import GLOBAL

            GLOBAL.note("incremental-full-rescan", reason)
            return self.rebuild(roster)
        start = min(int(start), len(roster))
        out = CommittedScan(
            self.nodes, roster, device=self.device, _prefix_from=self,
            _prefix_len=start,
        )
        COUNTERS.inc("incremental_resims_total")
        return out

    def rebuild(self, roster: List[dict]) -> "CommittedScan":
        """The full re-scan (the conservative fallback every degraded
        path lands on): identical results, no reused prefix."""
        COUNTERS.inc("incremental_full_rebuilds_total")
        return CommittedScan(self.nodes, roster, device=self.device)

    # -- conformance ---------------------------------------------------------

    def state_digest(self) -> dict:
        """Canonical committed-state summary for the conformance gates:
        per-node pod keys in commit order, per-position journal, failed
        reasons. Two CommittedScans over equal roster/nodes must
        compare equal — the delta-resim == full-re-scan contract."""

        def key(p):
            m = p.get("metadata") or {}
            return f"{m.get('namespace') or 'default'}/{m.get('name', '')}"

        return {
            "journal": [
                (
                    _CODE_NAMES[int(self.codes[i])],
                    self.node_names[i]
                    if int(self.codes[i]) != S_FAILED
                    else self.reasons[i],
                )
                for i in range(self.total)
            ],
            "nodes": {
                ns.name: [key(p) for p in ns.pods] for ns in self.oracle.nodes
            },
            "failed": [(key(up.pod), up.reason) for up in self.failed],
        }
