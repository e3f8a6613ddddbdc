"""Warm-session LRU + crash-safe session snapshot journal.

The port's copy of the JAX package's serve/sessions.py. The
multi-tenancy shape: a daemon holds MANY warm ``Session``s (one per
cluster fingerprint), each pinning an Oracle, a ClusterStatic encoding,
and its committed scan. Device memory is finite; this module bounds
them:

- **LRU by capacity** (``--max-sessions``): admitting a session past
  the bound evicts the least-recently-used one (its encodings and
  plan tensors become collectable; the next request for that cluster
  pays a rebuild, not an OOM).
- **Ledger-pressure eviction**: the coalescer's tick callback asks
  ``check_pressure()`` — when the device-memory ledger reports live
  bytes past the pressure fraction of the budget, the LRU session is
  evicted BEFORE the next dispatch OOMs (the predictive posture of
  obs/ledger.py applied to session state instead of chunk sizes).
- The **primary** session (the daemon's configured cluster) is
  pinned: eviction applies to secondaries only, so `simon serve`
  never sheds the cluster it was started for.

Every admit/evict/drain appends one record to the **session snapshot
journal** (``--snapshot PATH``) — the serve instance of the journal's
crash-safe JSONL discipline (fsync per append, torn tail recovered,
interior damage refused loudly). A restarted daemon resumes the
snapshot and logs which clusters were warm when the previous process
died.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional

from ..runtime.journal import Journal, config_fingerprint
from ..utils.trace import COUNTERS

#: fraction of the device budget past which the cache starts evicting
PRESSURE_FRACTION = 0.85

SNAPSHOT_VERSION = 1


class SessionSnapshotJournal(Journal):
    """The serve-subsystem journal: same format/recovery machinery,
    its own fault-injection crash point."""

    inject_site = "journal.fsync.serve"


def open_snapshot(path: str) -> SessionSnapshotJournal:
    """Create-or-resume the session snapshot at ``path`` (the
    ``--journal`` semantics: idempotent across daemon restarts)."""
    fp = config_fingerprint(
        {"format": "serve-session-snapshot", "version": SNAPSHOT_VERSION}
    )
    return SessionSnapshotJournal.open(path, fp)


def serve_keep_record(fingerprint: str):
    """The serve snapshot's checkpoint-compaction predicate: a verified
    checkpoint at delta seq N absorbs every journaled delta for this
    cluster with ``seq <= N``, so compaction drops exactly those.
    Non-delta records (admit/evict/drain), other clusters' deltas, and
    deltas past N are retained. Deltas journaled WITHOUT a seq (a
    pre-checkpoint-era journal) are also dropped: they were present
    when the checkpoint captured the session, hence absorbed by
    definition — and restore refuses to blind-apply unsequenced
    records on top of a checkpoint anyway (fleet/replay.py counts
    them loudly instead)."""

    def keep(rec: dict, upto_seq: int) -> bool:
        if (
            rec.get("kind") != "session"
            or rec.get("event") != "delta"
            or rec.get("fingerprint") != fingerprint
        ):
            return True
        seq = rec.get("seq")
        return isinstance(seq, int) and seq > upto_seq

    return keep


class SessionCache:
    """Fingerprint-keyed LRU of warm Sessions. All mutation under one
    lock; eviction never runs device work (dropping references is the
    whole point)."""

    def __init__(
        self,
        capacity: int = 8,
        snapshot: Optional[Journal] = None,
        pressure_fraction: float = PRESSURE_FRACTION,
    ):
        if capacity < 1:
            raise ValueError(f"session capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.pressure_fraction = pressure_fraction
        self._snapshot = snapshot
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, object]" = OrderedDict()
        self._pinned: set = set()
        self.evictions = 0

    # -- snapshot ------------------------------------------------------------

    def _record(self, event: str, fingerprint: str, **extra):
        if self._snapshot is None:
            return
        self._snapshot.append(
            {"kind": "session", "event": event, "fingerprint": fingerprint, **extra}
        )

    def record_delta(
        self,
        fingerprint: str,
        delta_record: dict,
        request_id: str = "",
        seq: Optional[int] = None,
    ):
        """Journal one applied cluster delta (POST /v1/cluster-delta):
        the snapshot then carries not just WHICH clusters were warm at
        a crash but what delta stream their warm state had absorbed —
        fsync'd per append like every session event. ``request_id``
        correlates the journal line with the HTTP request that carried
        the delta (the X-Simon-Request-Id contract); ``seq`` is the
        exact session delta sequence the apply assigned — the handle
        checkpoint compaction and snapshot-then-suffix replay filter
        on (fleet/replay.py)."""
        extra = {}
        if request_id:
            extra["requestId"] = request_id
        if seq is not None:
            extra["seq"] = int(seq)
        self._record("delta", fingerprint, delta=delta_record, **extra)

    # -- membership ----------------------------------------------------------

    def add(self, session, pinned: bool = False) -> List[str]:
        """Admit a session (most-recently-used position); returns the
        fingerprints evicted to stay within capacity."""
        fp = session.fingerprint
        with self._lock:
            self._sessions[fp] = session
            self._sessions.move_to_end(fp)
            if pinned:
                self._pinned.add(fp)
            evicted = self._evict_over_capacity_locked()
        self._record("admit", fp, pinned=pinned)
        for gone in evicted:
            self._note_eviction(gone, "capacity")
        COUNTERS.gauge("serve_sessions", float(len(self)))
        return evicted

    def get(self, fingerprint: str):
        """The warm session for a fingerprint (refreshes recency), or
        None — the caller builds and ``add``s."""
        with self._lock:
            s = self._sessions.get(fingerprint)
            if s is not None:
                self._sessions.move_to_end(fingerprint)
        return s

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def fingerprints(self) -> List[str]:
        with self._lock:
            return list(self._sessions)

    # -- eviction ------------------------------------------------------------

    def _evict_over_capacity_locked(self) -> List[str]:  # simonlint: disable=CONC001 - caller holds self._lock (the _locked suffix contract)
        evicted = []
        # oldest-first walk; pinned sessions are skipped, so a cache
        # of only pinned sessions can exceed capacity by their count
        while len(self._sessions) > self.capacity:
            victim = next(
                (fp for fp in self._sessions if fp not in self._pinned), None
            )
            if victim is None:
                break
            del self._sessions[victim]
            evicted.append(victim)
        return evicted

    def _note_eviction(self, fingerprint: str, reason: str):
        with self._lock:
            self.evictions += 1
        COUNTERS.inc("serve_session_evictions_total")
        COUNTERS.inc(f"serve_session_evictions_{reason}_total")
        COUNTERS.gauge("serve_sessions", float(len(self)))
        self._record("evict", fingerprint, reason=reason)

    def evict_lru(self, reason: str) -> Optional[str]:
        """Drop the least-recently-used unpinned session; returns its
        fingerprint (None when nothing is evictable)."""
        with self._lock:
            victim = next(
                (fp for fp in self._sessions if fp not in self._pinned), None
            )
            if victim is None:
                return None
            del self._sessions[victim]
        self._note_eviction(victim, reason)
        return victim

    def check_pressure(self) -> Optional[str]:
        """Ledger-pressure hook (called from the coalescer's tick
        callback): when live device bytes exceed the pressure fraction
        of the known budget, evict the LRU session. Returns the
        evicted fingerprint, or None (no budget known / no pressure /
        nothing evictable)."""
        from ..obs.ledger import device_memory_stats

        in_use, _peak, limit, _src = device_memory_stats()
        if not limit or in_use <= limit * self.pressure_fraction:
            return None
        return self.evict_lru("ledger_pressure")

    # -- lifecycle -----------------------------------------------------------

    def drain(self):
        """Journal the surviving sessions at shutdown (the warm-state
        inventory a restarted daemon reads back) and close the
        snapshot."""
        for fp in self.fingerprints():
            self._record("drain", fp)
        if self._snapshot is not None:
            self._snapshot.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "pinned": len(self._pinned),
                "capacity": self.capacity,
                "evictions": self.evictions,
            }
