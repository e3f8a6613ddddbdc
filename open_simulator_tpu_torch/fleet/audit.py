"""Failover audit timeline: a durable, phase-by-phase recovery log
(the port's copy of the JAX package's fleet/audit.py: the same events,
file format and validator, so either package reads the other's log).

``failover_seconds`` is one opaque number — kill-9 to the next 200
through the router. When it
regresses, the first question is WHICH phase got slow: did the probe
loop take longer to notice, did the slot lock linger, did the respawn
crawl, or did journal replay balloon? This module answers that with a
structured audit log the router appends as supervision happens:

    probe_flap -> declared_dead -> lock_reclaim -> respawn
        -> replay_progress -> first_200

- **Durable by construction**: JSONL, one fsync'd line per event,
  with a validated header line — the same torn-tail-tolerant journal
  discipline as fleet/replay.py (a crash mid-append loses at most the
  line being written, never corrupts the readable prefix).
- **Episodes**: one failover episode per (slot, episode#) opens at the
  first probe flap (or straight at death for a process exit), closes
  at the first 2xx answered through the respawned slot. A flap that
  recovers without a death closes as ``recovered`` — flap noise is
  visible but never counted as a failover.
- **Per-phase series**: closing an episode computes the phase
  durations that PARTITION the episode (they sum to the total by
  construction), publishes them as gauges/counters the router's
  telemetry runtime samples into the series store (chip_smoke.py's
  phase 28 prints them).

``validate_audit_log`` (and ``tools/validate_audit.py``) is the CI
gate: header intact, phases known and time-ordered, every complete
episode's durations summing to its total.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..models.validation import InputError
from ..utils.trace import COUNTERS

#: event phases in causal order; durations partition the episode
PHASES = (
    "probe_flap",
    "declared_dead",
    "lock_reclaim",
    "respawn",
    "replay_progress",
    "first_200",
)
#: the per-phase DURATION names (summary "phases" dict keys): each
#: measures the gap from the previous checkpoint to the named one
PHASE_DURATIONS = (
    "detect",      # first flap (or death) -> declared dead
    "reclaim",     # declared dead -> slot lock reclaimed
    "respawn",     # lock reclaimed -> replacement listening
    "replay",      # listening -> journal replay confirmed (delta seq)
    "first_200",   # replay confirmed -> first 2xx through the slot
)
_DURATION_OF = dict(zip(PHASES[1:], PHASE_DURATIONS))

AUDIT_KIND = "simon-fleet-audit"
AUDIT_VERSION = 1
#: events other than the six phases that may appear in a valid log
_META_PHASES = ("recovered", "failover_complete")


class FailoverAudit:
    """Append-only fsync'd JSONL failover audit log plus the live
    episode state machine. Thread-safe: the probe loop appends phases
    while forward threads call ``note_first_200`` on every answer
    (cheap no-op unless the slot has a pending failover)."""

    def __init__(self, path: str, clock=time.monotonic, wall=time.time):
        self.path = path
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        # slot -> open episode {"episode", "marks": {phase: mono}, "dead": bool}
        self._open: Dict[str, dict] = {}
        self._episode_counter: Dict[str, int] = {}
        #: completed episode summaries, oldest first (bench reads the
        #: newest for the doctor's phase breakdown)
        self.completed: List[dict] = []
        fresh = not os.path.exists(path)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")  # noqa: SIM115 - long-lived journal handle, closed in close()
        if fresh or os.path.getsize(path) == 0:
            self._append(
                {
                    "kind": AUDIT_KIND,
                    "version": AUDIT_VERSION,
                    "createdAt": self._wall(),
                }
            )

    # -- the fsync'd append --------------------------------------------------

    # audited: called WITH self._lock held by every note_* path — the
    # event order on disk must match the state machine's order
    def _append(self, doc: dict) -> None:  # simonlint: disable=CONC001
        self._f.write(json.dumps(doc, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    # audited: _clock/_wall are set once in __init__ and never
    # reassigned — reading them without the lock is race-free
    def _event(self, slot: str, phase: str, **extra) -> dict:  # simonlint: disable=CONC001
        doc = {
            "slot": slot,
            "phase": phase,
            "t": round(self._wall(), 6),
            "mono": round(self._clock(), 6),
        }
        doc.update({k: v for k, v in extra.items() if v is not None})
        return doc

    # -- episode state machine ------------------------------------------------

    # audited: called WITH self._lock held by _mark — split out only
    # to keep the state machine readable
    def _open_episode(self, slot: str) -> dict:  # simonlint: disable=CONC001
        ep = self._episode_counter.get(slot, 0) + 1
        self._episode_counter[slot] = ep
        state = {"episode": ep, "marks": {}, "dead": False}
        self._open[slot] = state
        return state

    # audited CONC002: the fsync'd append happens under the lock ON
    # PURPOSE — the on-disk event order IS the state machine's order;
    # audit events are rare (supervision cadence, not the hot path)
    def _mark(self, slot: str, phase: str, **extra) -> None:  # simonlint: disable=CONC002
        with self._lock:
            state = self._open.get(slot)
            if state is None:
                state = self._open_episode(slot)
            doc = self._event(slot, phase, episode=state["episode"], **extra)
            # first occurrence wins: repeated flaps (or respawn
            # retries) extend the log, not the checkpoint
            state["marks"].setdefault(phase, doc["mono"])
            if phase == "declared_dead":
                state["dead"] = True
            self._append(doc)

    def note_probe_flap(self, slot: str, failures: int = 0) -> None:
        self._mark(slot, "probe_flap", failures=failures)

    # audited CONC002: see _mark — ordered fsync under the lock is the
    # journal discipline, and probe events are supervision-cadence rare
    def note_probe_ok(self, slot: str) -> None:  # simonlint: disable=CONC002
        """A healthy probe closes a flap-only episode as recovered —
        no failover happened, the flaps stay on the record."""
        with self._lock:
            state = self._open.get(slot)
            if state is None or state["dead"]:
                return
            self._append(
                self._event(slot, "recovered", episode=state["episode"])
            )
            del self._open[slot]

    def note_declared_dead(self, slot: str, reason: str = "") -> None:
        self._mark(slot, "declared_dead", reason=reason or None)

    def note_lock_reclaim(self, slot: str) -> None:
        self._mark(slot, "lock_reclaim")

    # audited CONC002: see _mark — ordered fsync under the lock
    def note_respawn(  # simonlint: disable=CONC002
        self,
        slot: str,
        ok: bool = True,
        pid: Optional[int] = None,
        error: str = "",
    ) -> None:
        if not ok:
            # a failed spawn attempt is an event, not a checkpoint:
            # the phase clock keeps running until a spawn SUCCEEDS
            with self._lock:
                state = self._open.get(slot)
                if state is None:
                    return
                self._append(
                    self._event(
                        slot,
                        "respawn_failed",
                        episode=state["episode"],
                        error=error or None,
                    )
                )
            return
        self._mark(slot, "respawn", pid=pid)

    def note_replay_progress(
        self, slot: str, delta_seq: Optional[int] = None
    ) -> None:
        self._mark(slot, "replay_progress", deltaSeq=delta_seq)

    # audited: lock-free read of a dict the GIL keeps coherent — a
    # stale answer only delays the episode close by one forward
    def pending(self, slot: str) -> bool:  # simonlint: disable=CONC001
        """Whether the slot has a declared-dead episode awaiting its
        first 200 (the router's forward path checks this cheaply)."""
        state = self._open.get(slot)
        return bool(state and state["dead"])

    # audited CONC002: see _mark — ordered fsync under the lock; the
    # fast path (no pending episode) returns before any I/O
    def note_first_200(self, slot: str) -> Optional[dict]:  # simonlint: disable=CONC002
        """Close the slot's pending failover episode at its first
        2xx: emit the ``failover_complete`` summary (phase durations
        partitioning first-event -> first-200) and publish the
        duration gauges/counters. Returns the summary, or None when
        no failover was pending."""
        with self._lock:
            state = self._open.get(slot)
            if state is None or not state["dead"]:
                return None
            now = self._clock()
            marks = dict(state["marks"])
            marks["first_200"] = now
            start = min(marks.values())
            total = max(now - start, 0.0)
            phases: Dict[str, float] = {}
            prev = start
            for phase in PHASES[1:]:
                dur_name = _DURATION_OF[phase]
                at = marks.get(phase)
                if at is None:
                    phases[dur_name] = 0.0
                    continue
                phases[dur_name] = round(max(at - prev, 0.0), 6)
                prev = at
            summary = self._event(
                slot,
                "failover_complete",
                episode=state["episode"],
                totalSeconds=round(total, 6),
                phases=phases,
            )
            self._append(summary)
            self.completed.append(summary)
            del self._open[slot]
        COUNTERS.gauge("fleet_failover_seconds", round(total, 6))
        COUNTERS.inc(
            "fleet_failover_ms_total", max(int(round(total * 1000)), 1)
        )
        COUNTERS.inc("fleet_failovers_audited_total")
        for name, dur in phases.items():
            COUNTERS.gauge(f"fleet_failover_phase_seconds:{name}", dur)
        return summary

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:  # noqa: S110 - closing a dying journal is best-effort
                pass


# -- validation ---------------------------------------------------------------


def read_audit_log(path: str) -> tuple:
    """``(events, torn_tail)``: every parseable event line after the
    validated header. The LAST line may be torn (crash mid-append) and
    is dropped + counted; interior damage raises InputError — same
    posture as fleet/replay.py."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    if not lines:
        raise InputError(f"{path}: empty audit log (missing header)")
    try:
        header = json.loads(lines[0])
    except ValueError:
        raise InputError(f"{path}: audit header line is not JSON") from None
    if (
        not isinstance(header, dict)
        or header.get("kind") != AUDIT_KIND
        or header.get("version") != AUDIT_VERSION
    ):
        raise InputError(
            f"{path}: not a {AUDIT_KIND} v{AUDIT_VERSION} log "
            f"(header {str(header)[:120]!r})"
        )
    events: List[dict] = []
    torn = 0
    for i, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            if i == len(lines):
                torn = 1  # torn tail: drop, count, keep the prefix
                break
            raise InputError(
                f"{path}:{i}: interior audit line is not JSON"
            ) from None
        if not isinstance(doc, dict):
            raise InputError(f"{path}:{i}: audit event is not an object")
        events.append(doc)
    return events, torn


def validate_audit_log(
    path: str, sum_tolerance_s: float = 0.05
) -> dict:
    """Structural + arithmetic validation of one audit log. Checks:
    known phases only, per-episode monotone timestamps in causal
    order, and — for every ``failover_complete`` — all five phase
    durations present, non-negative, and summing to ``totalSeconds``
    within ``sum_tolerance_s``. Returns a summary dict; raises
    InputError on any violation."""
    events, torn = read_audit_log(path)
    known = set(PHASES) | set(_META_PHASES) | {"respawn_failed"}
    episodes: Dict[tuple, List[dict]] = {}
    for i, e in enumerate(events):
        phase = e.get("phase")
        if phase not in known:
            raise InputError(f"{path}: unknown phase {phase!r} (event {i})")
        slot = e.get("slot")
        if not isinstance(slot, str) or not slot:
            raise InputError(f"{path}: event {i} has no slot")
        if not isinstance(e.get("mono"), (int, float)):
            raise InputError(f"{path}: event {i} has no mono timestamp")
        episodes.setdefault((slot, e.get("episode")), []).append(e)
    complete = 0
    for (slot, ep), evs in sorted(episodes.items(), key=lambda kv: str(kv[0])):
        marks = {}
        for e in evs:
            marks.setdefault(e["phase"], float(e["mono"]))
        order = [marks[p] for p in PHASES if p in marks]
        if order != sorted(order):
            raise InputError(
                f"{path}: episode {slot}/{ep}: phases out of causal order"
            )
        summaries = [e for e in evs if e["phase"] == "failover_complete"]
        if len(summaries) > 1:
            raise InputError(
                f"{path}: episode {slot}/{ep}: {len(summaries)} summaries"
            )
        if not summaries:
            continue
        s = summaries[0]
        phases = s.get("phases")
        total = s.get("totalSeconds")
        if not isinstance(phases, dict) or not isinstance(
            total, (int, float)
        ):
            raise InputError(
                f"{path}: episode {slot}/{ep}: summary missing "
                "phases/totalSeconds"
            )
        for name in PHASE_DURATIONS:
            v = phases.get(name)
            if not isinstance(v, (int, float)) or v < 0:
                raise InputError(
                    f"{path}: episode {slot}/{ep}: phase duration "
                    f"{name!r} missing or negative: {v!r}"
                )
        sum_phases = sum(float(phases[n]) for n in PHASE_DURATIONS)
        if abs(sum_phases - float(total)) > max(
            sum_tolerance_s, 0.01 * float(total)
        ):
            raise InputError(
                f"{path}: episode {slot}/{ep}: phase durations sum "
                f"{sum_phases:.6f}s != totalSeconds {float(total):.6f}s"
            )
        complete += 1
    return {
        "path": path,
        "events": len(events),
        "episodes": len(episodes),
        "complete": complete,
        "tornTail": torn,
        "slots": sorted({slot for (slot, _ep) in episodes}),
    }
