"""The resident per-cluster mirror: one warm replayer continuously fed
by a live cluster (or a recorded feed), always current, always
queryable (the port's copy of the JAX package's twin/mirror.py).

A ``ClusterMirror`` fuses the three previously separate CLIs:

- **ingest** — steps come from a ``StepSource``: ``LiveSource`` wraps
  the shadow tailer's poll-diff loop (shadow/ingest.py, now
  event/binding-aware), ``FeedSource`` replays a recorded decision
  log at a configurable batch per poll (the self-conformance and CI
  path: simon tails its own recorded feed and must agree with itself
  100%).
- **apply** — every step routes through the shadow replayer, whose
  state lives on the cluster-delta substrate (twin/deltas.py): pod
  deltas are incremental commits on copy-on-write NodeStates, the
  probe replays the real scheduler's decision against the warm mirror
  (on the cuda engine one single-pod launch of the fused-scan kernel,
  B1 on a base plan) and classifies the divergence, and reality
  commits — the shadow auditor's loop, now resident.
- **observe** — agreement-rate, mirror-lag (age of the oldest
  unapplied observed step), backlog depth, flap and apply-error
  counts stream to the process counter registry as alertable gauges
  (``/metrics``, twin/server.py).

Concurrency: the tail loop and the query engines (twin/queries.py)
share ``self._lock`` — queries see a consistent mirror, the tail
never applies mid-query. Polls are bounded by ``max_catchup`` steps
per round (a recovered flap's giant diff converges across rounds
instead of blocking queries for its full length).

Failure posture (docs/ROBUSTNESS.md): a failed poll is a counted flap
with deterministic backoff (the tail survives apiserver restarts); a
step the substrate cannot apply (torn feed, corrupt record, injected
``twin.apply_delta`` fault) is counted, skipped, and surfaces as a
``degraded`` reason in ``/healthz`` — the mirror keeps serving with
the staleness visible rather than dying mid-shift.
"""

from __future__ import annotations

import collections
import copy
import threading
import time
from typing import List, Optional, Tuple

from ..models.validation import InputError
from ..runtime.errors import GuardError
from ..runtime.journal import Journal, config_fingerprint
from ..utils.trace import COUNTERS
from .deltas import MirrorApplicator  # noqa: F401  (re-export for callers)

#: backlog depth past which /healthz reports the mirror degraded
BACKLOG_DEGRADED = 4096

TWIN_SNAPSHOT_VERSION = 1


class TwinSnapshotJournal(Journal):
    """The twin's durable step journal (``--snapshot``): same crash-
    safe JSONL format/recovery as every other journal, its own
    fault-injection crash point. One record per successfully applied
    mirror step — the delta stream a restarted twin replays (after a
    checkpoint restore bounds the suffix, runtime/checkpoint.py)."""

    inject_site = "journal.fsync.twin"


def open_twin_snapshot(path: str) -> TwinSnapshotJournal:
    """Create-or-resume the twin step journal at ``path``."""
    fp = config_fingerprint(
        {"format": "twin-mirror-snapshot", "version": TWIN_SNAPSHOT_VERSION}
    )
    return TwinSnapshotJournal.open(path, fp)


def twin_keep_record(rec: dict, upto_seq: int) -> bool:
    """Checkpoint-compaction predicate for the twin journal: a
    verified checkpoint at seq N absorbs every journaled step with
    ``seq <= N``; everything else is retained."""
    if rec.get("kind") != "mirror" or rec.get("event") != "step":
        return True
    seq = rec.get("seq")
    return not (isinstance(seq, int) and seq <= upto_seq)


class LiveSource:
    """Step source over a live cluster: the shadow tailer's
    poll-diff-normalize loop (one paged LIST per poll, retry/breaker
    hardened underneath). When the caller already bootstrapped the
    tailer (the CLI needs the node LIST to build the mirror's cluster
    first), the recorded ``boot_steps`` replay from here instead of a
    second LIST."""

    def __init__(self, tailer, boot_steps: Optional[list] = None):
        self.tailer = tailer
        self._boot_steps = boot_steps
        self.exhausted = False  # a live cluster never runs out

    def bootstrap(self) -> Tuple[List[dict], list]:
        if self._boot_steps is not None:
            steps, self._boot_steps = self._boot_steps, None
            return [], steps
        return self.tailer.bootstrap()

    def poll(self) -> list:
        return self.tailer.poll()


class FeedSource:
    """Step source over a recorded decision log: each poll yields the
    next ``batch`` steps until the feed is exhausted. This is the
    mirror's self-conformance harness — tailing a feed simon itself
    recorded must replay at agreement 1.0 — and the CI smoke's
    synthetic live cluster."""

    def __init__(self, steps: list, batch: int = 64):
        if batch < 1:
            raise InputError(f"feed batch must be >= 1, got {batch}")
        self._steps = collections.deque(steps)
        self.batch = batch
        self.total = len(steps)

    @property
    def exhausted(self) -> bool:
        return not self._steps

    def bootstrap(self) -> Tuple[List[dict], list]:
        return [], []  # the cluster comes from the config

    def poll(self) -> list:
        out = []
        while self._steps and len(out) < self.batch:
            out.append(self._steps.popleft())
        return out


class ClusterMirror:
    """One mirrored cluster plus its tail-loop state. All mirrored
    state is guarded by ``lock`` — the tail thread applies under it,
    query engines read under it."""

    def __init__(
        self,
        cluster,
        source,
        engine: str = "cuda",
        max_catchup: int = 256,
        device=None,
    ):
        from ..shadow.replay import ShadowReplayer

        if max_catchup < 1:
            raise InputError(
                f"--max-catchup must be >= 1, got {max_catchup} (0 would "
                "never apply the backlog and the mirror would stop advancing)"
            )
        self.source = source
        self.max_catchup = int(max_catchup)
        self._lock = threading.RLock()
        # the probes' device: the card unless the caller names another
        # (resolved by the replayer, so a missing card fails here)
        self.replayer = ShadowReplayer(
            cluster, engine=engine, explain_divergences=False, device=device
        )
        # (observed_monotonic, step) — steps wait here between the
        # poll that observed them and the bounded catch-up that
        # applies them; the oldest entry's age IS the mirror lag
        self._backlog: "collections.deque" = collections.deque()
        self.polls = 0
        self.flaps = 0
        self.apply_errors = 0
        # the externally checkable applied-step sequence (the twin
        # analogue of serve's deltaSeq, exposed at /healthz and
        # /v1/state-digest) — restore identity is verified against it
        self.delta_seq = 0
        # durable step journal (attach AFTER any replay: replayed
        # steps are already on disk and must not re-append)
        self.journal: Optional[Journal] = None
        self.started_at = time.monotonic()

    # -- locking (query engines hold the mirror across one evaluation) --

    @property
    def lock(self) -> threading.RLock:
        return self._lock

    # `replayer` is bound once in __init__ and never rebound; only its
    # INTERIOR state needs the lock, so handing out the reference
    # itself is race-free
    @property
    def applicator(self) -> MirrorApplicator:  # simonlint: disable=CONC001 - immutable reference; interior mutation happens under the lock in _apply_step/stats
        return self.replayer._app

    @property
    def oracle(self):  # simonlint: disable=CONC001 - immutable reference (see applicator)
        return self.replayer.oracle

    @property
    def engine(self):  # simonlint: disable=CONC001 - immutable reference (see applicator)
        return self.replayer._engine

    @property
    def device(self):
        """The probes' and queries' torch device (None on the oracle
        engine)."""
        return self.replayer._app.device

    # -- lifecycle ----------------------------------------------------------

    def bootstrap(self):
        """First contact: LiveSource LISTs the cluster and the mirror
        applies the bootstrap placement deltas; FeedSource mirrors are
        born from the config's cluster and bootstrap is a no-op."""
        nodes, steps = self.source.bootstrap()
        with self._lock:
            for st in steps:
                # the journal append inside must be atomic with the state
                # mutation: a step must never be applied-but-unjournaled
                self._apply_step(st)  # simonlint: disable=CONC002
        self._export()
        return nodes

    def poll_once(self, budget=None) -> int:
        """One tail round: poll the source (a failure is a counted
        flap, never fatal), enqueue observed steps, apply at most
        ``max_catchup`` of the backlog under the lock. Returns the
        number of steps applied; raises nothing but ExecutionHalted
        (budget) and unclassified faults (which must stay loud)."""
        from ..runtime import inject as _inject
        from ..runtime.errors import ExternalIOError

        with self._lock:
            poll_no = self.polls
        try:
            # chaos seam: a `twin.poll` fault lands like a real
            # apiserver flap (reset/timeout/http:NNN/exio). The
            # network LIST runs OUTSIDE the mirror lock — a slow or
            # wedged apiserver must never block queries
            _inject.fire("twin.poll", poll=poll_no)
            steps = self.source.poll()
        except (ExternalIOError, OSError):
            with self._lock:
                self.flaps += 1
                self.polls += 1
            COUNTERS.inc("twin_tail_flaps_total")
            self._export()
            return -1  # the caller backs off
        now = time.monotonic()
        applied = 0
        with self._lock:
            self._backlog.extend((now, st) for st in steps)
            while self._backlog and applied < self.max_catchup:
                if budget is not None:
                    budget.check(f"twin tail (poll {poll_no}, catch-up)")
                _obs, st = self._backlog.popleft()
                # journal append atomic with the mutation (see bootstrap)
                self._apply_step(st)  # simonlint: disable=CONC002
                applied += 1
            if self._backlog:
                COUNTERS.inc(
                    "twin_tail_deferred_steps_total", len(self._backlog)
                )
            self.polls += 1
        self._export()
        return applied

    def drain_backlog(self, budget=None) -> int:
        """Apply every deferred step (shutdown / end-of-feed path)."""
        applied = 0
        with self._lock:
            while self._backlog:
                if budget is not None:
                    budget.check("twin tail (final catch-up)")
                _obs, st = self._backlog.popleft()
                # journal append atomic with the mutation (see bootstrap)
                self._apply_step(st)  # simonlint: disable=CONC002
                applied += 1
        self._export()
        return applied

    def _apply_step(self, st):  # simonlint: disable=CONC001 - callers hold self._lock (poll_once/drain_backlog/bootstrap/replay)
        try:
            self.replayer.step(st)
        except (GuardError, InputError) as e:
            # a step the substrate cannot apply (torn feed, injected
            # fault, corrupt record): counted and skipped — the mirror
            # keeps serving, /healthz carries the degradation
            self.apply_errors += 1
            COUNTERS.inc("twin_apply_errors_total")
            from ..utils.trace import GLOBAL

            GLOBAL.append_note(
                "twin-apply-error", f"step {getattr(st, 'seq', '?')}: {str(e)[:120]}"
            )
            return
        self.delta_seq += 1
        if self.journal is not None:
            self.journal.append(
                {
                    "kind": "mirror",
                    "event": "step",
                    "seq": self.delta_seq,
                    "step": st.as_record(),
                }
            )

    # -- observability ------------------------------------------------------

    def _lag_locked(self) -> float:  # simonlint: disable=CONC001 - caller holds self._lock (the _locked suffix contract)
        if not self._backlog:
            return 0.0
        return max(0.0, time.monotonic() - self._backlog[0][0])

    def mirror_lag_s(self) -> float:
        """Age of the oldest observed-but-unapplied step (0.0 when the
        mirror is current) — the alertable staleness signal."""
        with self._lock:
            return self._lag_locked()

    def agreement_rate(self) -> float:
        with self._lock:
            return self.replayer.report.agreement_rate

    def state_digest(self) -> str:
        """Canonical digest of the mirrored capacity state (the
        delta-substrate ``state_dict`` — twin/deltas.py), the twin's
        ``/v1/state-digest`` value: a restored or replacement mirror
        is correct iff its digest equals the one it replaced. Cheap:
        no device work, safe to poll."""
        from .deltas import state_dict

        with self._lock:
            return config_fingerprint(state_dict(self.replayer._app))

    def applied_seq(self) -> int:
        with self._lock:
            return self.delta_seq

    def _export(self):
        with self._lock:
            rep = self.replayer.report
            agreement = rep.agreement_rate
            backlog = float(len(self._backlog))
            polls = float(self.polls)
            lag = self._lag_locked()
        COUNTERS.gauge("twin_agreement_rate", agreement)
        COUNTERS.gauge("twin_mirror_lag_seconds", round(lag, 6))
        COUNTERS.gauge("twin_backlog", backlog)
        COUNTERS.gauge("twin_polls", polls)

    def degraded_reasons(self) -> List[str]:
        reasons = []
        with self._lock:
            apply_errors = self.apply_errors
            backlog = len(self._backlog)
            lag = self._lag_locked()
        if apply_errors:
            reasons.append(
                f"{apply_errors} delta step(s) could not be applied "
                "(mirror may be stale; see twin_apply_errors_total)"
            )
        if backlog > BACKLOG_DEGRADED:
            reasons.append(
                f"tail backlog {backlog} steps deep "
                f"(> {BACKLOG_DEGRADED}); mirror lag {lag:.1f}s"
            )
        return reasons

    def stats(self) -> dict:
        exhausted = bool(getattr(self.source, "exhausted", False))
        with self._lock:
            rep = self.replayer.report
            app = self.replayer._app
            return {
                "polls": self.polls,
                "flaps": self.flaps,
                "backlog": len(self._backlog),
                "mirrorLagSeconds": round(self._lag_locked(), 6),
                "steps": rep.steps,
                "decisions": rep.decisions,
                "agreementRate": rep.agreement_rate,
                "divergences": rep.divergence_count,
                "warmBuilds": rep.warm_builds,
                "reloads": rep.reloads,
                "deltasApplied": app.applied,
                "deltaSkips": app.skips,
                "deltaSeq": self.delta_seq,
                "applyErrors": self.apply_errors,
                "pendingPods": len(app.pending),
                "nodes": len(app.oracle.nodes),
                "feedExhausted": exhausted,
            }

    # -- state snapshot (the timeline bridge) -------------------------------

    def snapshot_cluster(self):  # simonlint: disable=CONC001 - caller holds self.lock (queries.forecast takes it across the snapshot)
        """The mirrored state as a loadable cluster: current nodes plus
        every committed pod in its bound form — what a capacity
        forecast steps forward from (twin/queries.py) and what
        ``simon apply`` would load if the mirror were written to disk.
        Caller holds the lock."""
        import copy

        from ..models.decode import ResourceTypes

        cluster = ResourceTypes()
        cluster.nodes = [copy.deepcopy(ns.node) for ns in self.oracle.nodes]
        cluster.pods = [
            copy.deepcopy(p) for ns in self.oracle.nodes for p in ns.pods
        ]
        base = self.replayer.cluster
        cluster.pod_disruption_budgets = list(base.pod_disruption_budgets)
        cluster.priority_classes = list(base.priority_classes)
        return cluster


# -- checkpoint capture / materialization (runtime/checkpoint.py) -----------


def capture_mirror(mirror: ClusterMirror):
    """The CheckpointManager ``capture`` hook for a twin mirror: one
    consistent cut under the mirror lock — identity (the base-cluster
    fingerprint the divergence report carries), the applied-step
    sequence, the capacity-state digest, and a payload that
    re-materializes the applicator: nodes, bound pods (per-node, in
    placement order, each stamped with its node), pending pods, and
    the pdb/priority context the oracle rebuild needs."""
    from ..runtime.checkpoint import CheckpointState
    from .deltas import state_dict

    with mirror.lock:
        app = mirror.applicator
        bound = []
        for ns in app.oracle.nodes:
            for p in ns.pods:
                pod = copy.deepcopy(p)
                pod.setdefault("spec", {})["nodeName"] = ns.name
                bound.append(pod)
        payload = {
            "nodes": [copy.deepcopy(ns.node) for ns in app.oracle.nodes],
            "bound": bound,
            "pending": [copy.deepcopy(p) for p in app.pending.values()],
            "pdbs": copy.deepcopy(app.cluster.pod_disruption_budgets),
            "priorityClasses": copy.deepcopy(app.cluster.priority_classes),
        }
        return CheckpointState(
            fingerprint=mirror.replayer.report.fingerprint,
            delta_seq=mirror.delta_seq,
            state_digest=config_fingerprint(state_dict(app)),
            payload=payload,
        )


def twin_materialized_digest(payload: dict) -> str:
    """State digest of a FRESH materialization of a twin checkpoint
    payload: a new oracle-engine applicator over the payload nodes,
    every bound pod re-placed, the pending queue refilled —
    ``state_dict`` is engine-independent (it reads only oracle
    NodeStates), so this digest matching the live mirror's proves the
    payload restores to the same capacity state."""
    from ..models.decode import ResourceTypes
    from .deltas import _own_pod, _pod_key, state_dict

    cold = ResourceTypes()
    cold.nodes = [copy.deepcopy(n) for n in payload.get("nodes", [])]
    cold.pod_disruption_budgets = copy.deepcopy(payload.get("pdbs", []))
    cold.priority_classes = copy.deepcopy(payload.get("priorityClasses", []))
    app = MirrorApplicator(cold, engine="oracle")
    for pod in payload.get("bound", []):
        p = _own_pod(pod)
        app.oracle.place_existing_pod(p)
        app._bound[_pod_key(p)] = (p.get("spec") or {}).get("nodeName") or ""
    for pod in payload.get("pending", []):
        app.pending[_pod_key(pod)] = _own_pod(pod)
    return config_fingerprint(state_dict(app))


def restore_mirror_state(mirror: ClusterMirror, payload: dict, seq: int):
    """Adopt a VERIFIED checkpoint payload as the mirror's state (the
    caller has already proven ``twin_materialized_digest(payload)``
    equals the checkpoint header's digest): rebuild the applicator's
    oracle over the payload nodes, re-place the bound pods, refill the
    pending queue and the bound index, and pin ``delta_seq`` so the
    journal suffix replay skips exactly the absorbed prefix."""
    from .deltas import _own_pod, _pod_key

    with mirror.lock:
        app = mirror.applicator
        app._build([copy.deepcopy(n) for n in payload.get("nodes", [])])
        app.pending.clear()
        app._bound.clear()
        for pod in payload.get("bound", []):
            p = _own_pod(pod)
            app.oracle.place_existing_pod(p)
            app._bound[_pod_key(p)] = (
                (p.get("spec") or {}).get("nodeName") or ""
            )
        for pod in payload.get("pending", []):
            app.pending[_pod_key(pod)] = _own_pod(pod)
        mirror.delta_seq = int(seq)


def replay_mirror_journal(mirror: ClusterMirror, path: str) -> dict:
    """Snapshot-then-suffix bootstrap for a restarted twin (the twin
    analogue of fleet/replay.replay_into_session): restore the newest
    trustable checkpoint generation (refused generations fall back
    loudly, ``ckpt_restore_fallback_total``), then replay the
    journal's step records with ``seq`` past the restored sequence.
    Read-only on the journal file — the caller attaches the mirror's
    append journal (``open_twin_snapshot``) AFTER this returns, so
    replayed steps never re-append."""
    from ..fleet.replay import read_session_events
    from ..runtime.checkpoint import (
        CheckpointMismatch,
        checkpoint_dir,
        list_checkpoints,
        load_checkpoint,
    )
    from ..shadow.log import Step

    t0 = time.monotonic()
    restored = None
    generations = list_checkpoints(checkpoint_dir(path))
    for seq, gen_path in generations:
        try:
            header, payload = load_checkpoint(
                gen_path, expect_fingerprint=mirror.replayer.report.fingerprint
            )
            fresh = twin_materialized_digest(payload)
            if fresh != header["stateDigest"]:
                raise CheckpointMismatch(
                    f"{gen_path}: payload re-materializes to digest "
                    f"{fresh!r}, header claims {header['stateDigest']!r}; "
                    "refusing this generation"
                )
            restore_mirror_state(mirror, payload, header["deltaSeq"])
        except CheckpointMismatch as e:
            COUNTERS.inc("ckpt_restore_fallback_total")
            import logging

            logging.getLogger("simon.twin").warning(
                "twin checkpoint generation refused, falling back to the "
                "previous one (longer replay, never silent wrong state): %s",
                e,
            )
            continue
        COUNTERS.inc("ckpt_restore_total")
        restored = {
            "deltaSeq": int(header["deltaSeq"]),
            "stateDigest": header["stateDigest"],
            "path": gen_path,
        }
        break
    base_seq = restored["deltaSeq"] if restored else 0
    fp = config_fingerprint(
        {"format": "twin-mirror-snapshot", "version": TWIN_SNAPSHOT_VERSION}
    )
    try:
        records, dropped = read_session_events(path, fp)
    except InputError:
        if restored is None:
            raise
        # checkpoint restored but the journal is unreadable: serve the
        # verified snapshot state rather than dying (the suffix since
        # the checkpoint is lost and SAID so)
        records, dropped = [], 0
    summary = {
        "steps": 0,
        "skippedPrefix": 0,
        "checkpoint": restored,
        "dropped": dropped,
    }
    with mirror.lock:
        for rec in records:
            if rec.get("kind") != "mirror" or rec.get("event") != "step":
                continue
            seq = rec.get("seq")
            if isinstance(seq, int) and seq <= base_seq:
                summary["skippedPrefix"] += 1
                continue
            mirror._apply_step(Step.from_record(rec["step"]))
            if isinstance(seq, int):
                # pin to the journaled sequence (an apply error must
                # not let replayed seqs drift from the recorded ones)
                mirror.delta_seq = int(seq)
            summary["steps"] += 1
    COUNTERS.inc("fleet_replay_deltas_total", summary["steps"])
    if summary["skippedPrefix"]:
        COUNTERS.inc(
            "ckpt_restore_deltas_skipped_total", summary["skippedPrefix"]
        )
    if dropped:
        COUNTERS.inc("fleet_replay_torn_tail_total", dropped)
    if restored:
        COUNTERS.gauge(
            "ckpt_restore_seconds", round(time.monotonic() - t0, 6)
        )
    if generations and restored is None:
        import logging

        logging.getLogger("simon.twin").warning(
            "all %d twin checkpoint generation(s) refused; recovering by "
            "full journal replay",
            len(generations),
        )
    return summary
