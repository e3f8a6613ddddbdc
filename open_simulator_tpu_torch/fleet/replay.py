"""Snapshot-then-suffix bootstrap for a replacement serve daemon (the
port's copy of the JAX package's fleet/replay.py).

A serve daemon journals every applied cluster delta to its session
snapshot (serve/sessions.py ``record_delta``) and — with
``--checkpoint-interval`` — periodically writes a verified checkpoint
of the committed session (runtime/checkpoint.py). When the daemon
dies, a replacement (``simon serve --replay-snapshot``) bootstraps in
two stages:

1. **Restore** (``restore_into_session``): walk the retained
   checkpoint generations newest → oldest; the first one whose header
   validates AND whose payload re-materializes to the recorded state
   digest is adopted wholesale (``Session.restore_state``). A refused
   generation — torn, corrupt, stale toolchain, digest mismatch — is
   counted (``ckpt_restore_fallback_total``) and logged, and the walk
   falls back to the previous generation: a longer replay, never a
   silent wrong state. No usable generation means full-journal replay.
2. **Suffix replay**: the journal's delta records with ``seq`` past
   the restored checkpoint replay through ``Session.apply_delta``;
   the absorbed prefix is skipped by sequence (correct even when the
   compactor never got to truncate it). Replay cost is therefore
   O(--checkpoint-interval), not O(daemon lifetime).

The kernel libraries come from the content-addressed store the dead
daemon filled (``--aot-store``, incremental/store.py): the replacement
answers its first request at zero nvcc builds. Its committed state
comes from this replay (the same ``/v1/state-digest`` triple as the
dead daemon's).

Reading follows the runtime/journal.py recovery discipline: header
fingerprint validated FIRST, complete records replayed, a torn final
line (the daemon died mid-append) dropped and counted, interior
damage refused loudly (``JournalMismatch`` — serving un-replayed
state would answer requests wrongly, which is worse than refusing to
boot). The read is strictly read-only: the serve daemon itself
resumes the same file for append afterwards (and truncates the torn
tail durably); replay must not race that by holding the file open.

Injection seam ``fleet.replay`` fires once per replay. A ``simon fleet``
replica runs this on every respawn (fleet/replica.py ``serve_argv``).
"""

from __future__ import annotations

import json
import logging
import time
from typing import List, Optional, Tuple

from ..runtime import inject as _inject
from ..runtime.journal import JOURNAL_VERSION, JournalMismatch
from ..utils.trace import COUNTERS

log = logging.getLogger("simon.fleet")


def read_session_events(path: str, fingerprint: str) -> Tuple[List[dict], int]:
    """Read a session snapshot journal read-only. Returns
    ``(records, dropped)``: every complete non-header record in append
    order, and the count of torn trailing lines discarded. Raises
    ``JournalMismatch`` on header/fingerprint mismatch or interior
    damage — the same refusals as ``Journal.resume``."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise JournalMismatch(f"cannot replay from {path}: {e}") from e
    lines = raw.split(b"\n")
    if not lines or not lines[0].strip():
        raise JournalMismatch(f"{path}: empty journal, nothing to replay")
    try:
        header = json.loads(lines[0])
    except ValueError as e:
        raise JournalMismatch(f"{path}: unreadable journal header: {e}") from e
    if not isinstance(header, dict) or header.get("kind") != "header":
        raise JournalMismatch(f"{path}: first record is not a journal header")
    if header.get("version") != JOURNAL_VERSION:
        raise JournalMismatch(
            f"{path}: journal version {header.get('version')!r} != "
            f"{JOURNAL_VERSION}"
        )
    if header.get("fingerprint") != fingerprint:
        raise JournalMismatch(
            f"{path}: journal fingerprint {header.get('fingerprint')!r} does "
            f"not match the expected snapshot format ({fingerprint!r}); "
            "refusing to replay a journal from a different subsystem"
        )
    body, tail = lines[1:-1], lines[-1]
    records: List[dict] = []
    for i, line in enumerate(body):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise JournalMismatch(
                f"{path}: corrupt journal record on line {i + 2}: {e}"
            ) from e
        if not isinstance(rec, dict):
            raise JournalMismatch(
                f"{path}: corrupt journal record on line {i + 2}: "
                "record is not an object"
            )
        records.append(rec)
    dropped = 0
    if tail.strip():
        # no trailing newline: the replica died mid-append. Keep the
        # record only if it parses whole; else it is the torn tail —
        # expected damage, dropped and counted, never fatal.
        try:
            rec = json.loads(tail)
        except ValueError:
            rec = None
        if isinstance(rec, dict):
            records.append(rec)
        else:
            dropped = 1
    return records, dropped


def restore_into_session(session, snapshot_path: str) -> Optional[dict]:
    """Adopt the newest TRUSTABLE checkpoint generation for
    ``snapshot_path`` into ``session``. Returns
    ``{"deltaSeq", "stateDigest", "path"}`` on success, None when no
    generation exists or every one was refused (the caller replays the
    full journal). The trust ladder per generation, newest first:
    header validation (kind/version/toolchain/fingerprint/sha256,
    ``load_checkpoint``), then the payload re-materialized to a fresh
    roster expansion whose digest must equal the header's
    ``stateDigest`` — all BEFORE the session is touched, under one
    delta-lock hold, so a refused generation leaves the session
    exactly as it was."""
    from ..runtime.checkpoint import (
        CheckpointMismatch,
        checkpoint_dir,
        list_checkpoints,
        load_checkpoint,
    )
    from ..serve.session import (
        cluster_from_payload,
        materialized_state_digest,
    )

    generations = list_checkpoints(checkpoint_dir(snapshot_path))
    for seq, path in generations:
        try:
            header, payload = load_checkpoint(
                path, expect_fingerprint=session.fingerprint
            )
            # _delta_lock is an RLock (session.py): restore_state
            # re-acquiring it under this hold is reentrant, not a
            # deadlock — the outer hold makes verify+swap one atomic cut
            with session._delta_lock:  # simonlint: disable=CONC002
                cluster = cluster_from_payload(payload)
                fresh = materialized_state_digest(cluster)
                if fresh != header["stateDigest"]:
                    raise CheckpointMismatch(
                        f"{path}: payload re-materializes to digest "
                        f"{fresh!r}, header claims "
                        f"{header['stateDigest']!r}; refusing this "
                        "generation"
                    )
                session.restore_state(cluster, header["deltaSeq"])
        except CheckpointMismatch as e:
            COUNTERS.inc("ckpt_restore_fallback_total")
            log.warning(
                "checkpoint generation refused, falling back to the "
                "previous one (longer replay, never silent wrong state): %s",
                e,
            )
            continue
        COUNTERS.inc("ckpt_restore_total")
        return {
            "deltaSeq": int(header["deltaSeq"]),
            "stateDigest": header["stateDigest"],
            "path": path,
        }
    if generations:
        log.warning(
            "all %d checkpoint generation(s) under %s refused; "
            "recovering by full journal replay",
            len(generations),
            checkpoint_dir(snapshot_path),
        )
    return None


def replay_into_session(session, path: str, use_checkpoints: bool = True) -> dict:
    """Bootstrap ``session`` from the snapshot at ``path``: checkpoint
    restore first (``use_checkpoints``), then replay the journal's
    delta suffix (deltas recorded against other cluster fingerprints
    are skipped — a multi-session snapshot replays only the primary's
    stream). Returns a summary dict: ``deltas`` REPLAYED for this
    fingerprint, ``applied``/``skipped``/``reloads`` from
    ``apply_delta``, ``skippedPrefix`` records absorbed by the restored
    checkpoint, ``checkpoint`` (the restore summary or None),
    ``dropped`` torn-tail lines, and the journaled ``requestIds`` (the
    X-Simon-Request-Id correlation carried across the failover)."""
    from ..serve.sessions import SNAPSHOT_VERSION
    from ..runtime.journal import config_fingerprint
    from ..twin.deltas import ClusterDelta

    t0 = time.perf_counter()
    _inject.fire("fleet.replay", path=path)
    restored = restore_into_session(session, path) if use_checkpoints else None
    base_seq = restored["deltaSeq"] if restored else 0
    fp = config_fingerprint(
        {"format": "serve-session-snapshot", "version": SNAPSHOT_VERSION}
    )
    records, dropped = read_session_events(path, fp)
    summary = {
        "deltas": 0,
        "applied": 0,
        "skipped": 0,
        "reloads": 0,
        "skippedPrefix": 0,
        "checkpoint": restored,
        "dropped": dropped,
        "requestIds": [],
    }
    for rec in records:
        if rec.get("kind") != "session" or rec.get("event") != "delta":
            continue
        if rec.get("fingerprint") != session.fingerprint:
            continue
        seq = rec.get("seq")
        if base_seq:
            if isinstance(seq, int):
                if seq <= base_seq:
                    summary["skippedPrefix"] += 1
                    continue
            else:
                # a pre-checkpoint-era record with no sequence: it was
                # in the journal when the checkpoint captured the
                # session, so it is absorbed — blind-applying it on
                # top of the restore would double-apply. Skipped LOUDLY.
                summary["skippedPrefix"] += 1
                COUNTERS.inc("fleet_replay_unsequenced_skipped_total")
                log.warning(
                    "unsequenced delta record in %s skipped after a "
                    "checkpoint restore at seq %d (absorbed by the "
                    "snapshot; re-applying would double-count)",
                    path,
                    base_seq,
                )
                continue
        summary["deltas"] += 1
        rid = rec.get("requestId")
        if rid:
            summary["requestIds"].append(rid)
        out = session.apply_delta(ClusterDelta.from_record(rec["delta"]))
        if out == "skipped":
            summary["skipped"] += 1
        else:
            summary["applied"] += 1
            if out == "reloaded":
                summary["reloads"] += 1
    COUNTERS.inc("fleet_replayed_deltas_total", summary["deltas"])
    COUNTERS.inc("fleet_replay_deltas_total", summary["deltas"])
    if summary["skippedPrefix"]:
        COUNTERS.inc(
            "ckpt_restore_deltas_skipped_total", summary["skippedPrefix"]
        )
    if dropped:
        COUNTERS.inc("fleet_replay_torn_tail_total", dropped)
    if restored:
        COUNTERS.gauge(
            "ckpt_restore_seconds", round(time.perf_counter() - t0, 6)
        )
    return summary
