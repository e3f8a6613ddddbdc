"""Shadow decision logs — normalized scheduling decisions on disk.

One JSONL file riding the journal discipline (runtime/journal.py):
a header line first, one record per line, flushed and fsync'd per
append, torn final line tolerated on read, interior damage and
fingerprint mismatches refused loudly.

Record kinds (format version 1):

- ``{"kind": "header", "version": 1, "format": "shadow-decision-log",
  "fingerprint": "..."}`` — the fingerprint digests the cluster the
  log was recorded against (``cluster_fingerprint``), so a log can
  never silently replay onto a different cluster;
- ``{"kind": "decision", "seq": N, "pod": {...}, "node": "..."|null,
  "reason": "...", "deltas": [...]}`` — one scheduling decision: the
  UNSCHEDULED pod (no ``spec.nodeName``), the node the real scheduler
  chose (null = it failed, with its reason), and the cluster-delta ops
  that preceded the decision (preemption evictions, node churn);
- ``{"kind": "delta", "seq": N, "ops": [...]}`` — cluster mutations
  with no decision attached (pre-bound pods arriving, node add/remove).

Delta ops (applied in list order, before the step's decision):

- ``{"op": "place_pod", "pod": {...}}`` — a pod that arrived already
  bound (``spec.nodeName`` set); occupies capacity, never scheduled;
- ``{"op": "evict_pod", "namespace": ..., "name": ..., "node": ...}``
  — a pod removed from its node (preemption victim, deletion);
- ``{"op": "add_node", "node": {...}}`` / ``{"op": "remove_node",
  "name": ...}`` — node churn (a remove costs the replayer a state
  reload; everything else is an incremental commit).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..runtime.journal import JournalMismatch, config_fingerprint

LOG_VERSION = 1
LOG_FORMAT = "shadow-decision-log"


def cluster_fingerprint(cluster) -> str:
    """Digest of a loaded ResourceTypes — the same construction as the
    serve Session's fingerprint, so a decision log and a warm session
    over the same cluster agree on identity."""
    return config_fingerprint(
        {k: getattr(cluster, k) for k in sorted(vars(cluster))}
    )


@dataclass
class Step:
    """One log step: a scheduling decision, or a bare delta batch."""

    seq: int
    kind: str  # "decision" | "delta"
    pod: Optional[dict] = None
    node: Optional[str] = None
    reason: str = ""
    deltas: List[dict] = field(default_factory=list)

    @property
    def pod_key(self) -> Tuple[str, str]:
        meta = (self.pod or {}).get("metadata") or {}
        return (meta.get("namespace") or "default", meta.get("name", ""))

    def as_record(self) -> dict:
        if self.kind == "delta":
            return {"kind": "delta", "seq": self.seq, "ops": self.deltas}
        rec = {
            "kind": "decision",
            "seq": self.seq,
            "pod": self.pod,
            "node": self.node,
        }
        if self.reason:
            rec["reason"] = self.reason
        if self.deltas:
            rec["deltas"] = self.deltas
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "Step":
        kind = rec.get("kind")
        if kind == "delta":
            return cls(
                seq=int(rec.get("seq", 0)),
                kind="delta",
                deltas=list(rec.get("ops") or []),
            )
        if kind != "decision":
            raise ValueError(f"unknown decision-log record kind {kind!r}")
        pod = rec.get("pod")
        if not isinstance(pod, dict):
            raise ValueError("decision record has no pod object")
        node = rec.get("node")
        return cls(
            seq=int(rec.get("seq", 0)),
            kind="decision",
            pod=pod,
            node=str(node) if node is not None else None,
            reason=str(rec.get("reason") or ""),
            deltas=list(rec.get("deltas") or []),
        )


class DecisionLogWriter:
    """Append-only fsync'd JSONL writer (the journal discipline: a
    crash keeps every decision that finished before it)."""

    def __init__(self, path: str, fingerprint: str):
        self.path = path
        self.fingerprint = fingerprint
        self.written = 0
        self._f = open(path, "w", encoding="utf-8")
        self._emit(
            {
                "kind": "header",
                "version": LOG_VERSION,
                "format": LOG_FORMAT,
                "fingerprint": fingerprint,
            }
        )

    def _emit(self, rec: dict):
        from ..runtime import inject as _inject

        line = json.dumps(rec, separators=(",", ":")) + "\n"
        # chaos crash point (runtime/inject.py): a `crash` clause
        # leaves a durable torn prefix, like a real mid-append death
        _inject.crash_write("journal.fsync.shadow", self._f, line)
        self._f.write(line)
        self._f.flush()
        os.fsync(self._f.fileno())

    def append(self, step: Step):
        self._emit(step.as_record())
        self.written += 1

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_decision_log(
    path: str, fingerprint: Optional[str] = None
) -> Tuple[List[Step], dict]:
    """Read a decision log: validate the header (and, when given, the
    cluster fingerprint — mismatch refuses loudly, JournalMismatch),
    replay complete records, tolerate a torn final line. Returns
    ``(steps, meta)`` where meta carries the header plus
    ``{"dropped": n}`` for the torn-tail count."""
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if not lines or not lines[0].strip():
        raise JournalMismatch(f"{path}: empty decision log")
    try:
        header = json.loads(lines[0])
    except ValueError as e:
        raise JournalMismatch(f"{path}: unreadable decision-log header: {e}") from e
    if not isinstance(header, dict) or header.get("kind") != "header":
        raise JournalMismatch(f"{path}: first record is not a header")
    if header.get("format") != LOG_FORMAT:
        raise JournalMismatch(
            f"{path}: not a shadow decision log (format "
            f"{header.get('format')!r})"
        )
    if header.get("version") != LOG_VERSION:
        raise JournalMismatch(
            f"{path}: decision-log version {header.get('version')!r} != "
            f"{LOG_VERSION}"
        )
    if fingerprint is not None and header.get("fingerprint") != fingerprint:
        raise JournalMismatch(
            f"{path}: decision log fingerprint "
            f"{header.get('fingerprint')!r} does not match this cluster "
            f"({fingerprint!r}); refusing to replay a log recorded against "
            "different inputs"
        )
    body, tail = lines[1:-1], lines[-1]
    steps: List[Step] = []
    dropped = 0
    for i, line in enumerate(body):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
        except ValueError as e:
            # interior damage: the file was not grown append-only
            raise JournalMismatch(
                f"{path}: corrupt decision-log record on line {i + 2}: {e}"
            ) from e
        steps.append(Step.from_record(rec))
    if tail.strip():
        try:
            rec = json.loads(tail)
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
            steps.append(Step.from_record(rec))
        except ValueError:
            dropped = 1  # torn mid-append: expected damage, drop it
    meta = dict(header)
    meta["dropped"] = dropped
    return steps, meta
