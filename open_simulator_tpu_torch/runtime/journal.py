"""Crash-safe resumable planning journal (the port's copy of the JAX
package's runtime/journal.py).

Long runs (an N+K escalation over a 100k-pod cluster, a large chaos
sweep) append every completed unit of work — capacity-probe results and
outage-scenario verdicts — to an append-only JSONL file, one record per
line, fsync'd per append. ``simon apply/chaos --resume PATH`` replays
the journal and skips finished work: journaled probes are served from
the journal instead of the device (CapacitySweep.probe), journaled
scenario verdicts reconstruct their outcomes without a scan
(ChaosEngine.run).

File format (version 1):

- line 1: ``{"kind": "header", "version": 1, "fingerprint": "..."}``
- then one record per line; ``kind`` is ``probe`` or ``scenario``

The fingerprint is a digest of the loaded inputs and the flags that
shape the work (config_fingerprint). Resume validates it FIRST and
refuses loudly on mismatch (``JournalMismatch``, an input error): a
journal recorded against different inputs must never silently poison a
plan. A torn final line (the process died mid-append) is expected
damage: resume replays only complete records, truncates the torn tail,
and continues appending from the last good byte. Damage before the
last line means the file did not grow append-only — that is refused
like a fingerprint mismatch rather than risking a half-replayed state.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Callable, Dict, Optional

from ..models.validation import InputError
from . import inject as _inject

JOURNAL_VERSION = 1


class JournalMismatch(InputError):
    """The journal does not belong to this (config, flags) — refuse to
    resume rather than mix results from different runs."""


def config_fingerprint(*parts) -> str:
    """Order-sensitive digest of arbitrary JSON-serializable inputs
    (non-serializable leaves fall back to repr)."""
    blob = json.dumps(parts, sort_keys=True, separators=(",", ":"), default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


class Journal:
    """One open journal file. Use ``create`` for a fresh run,
    ``resume`` to continue an interrupted one."""

    #: fault-injection crash point fired before each durable append
    #: (runtime/inject.py)
    inject_site = "journal.fsync.apply"

    def __init__(self, path: str, fingerprint: str):
        self.path = path
        self.fingerprint = fingerprint
        self.probes: Dict[int, dict] = {}
        self.scenarios: Dict[str, dict] = {}
        self.replayed = 0  # complete records recovered on resume
        self.dropped = 0  # torn trailing records discarded on resume
        self._f = None
        #: serializes appends from threads that share one journal, and
        #: appends against ``rewrite`` (checkpoint compaction swaps the
        #: file under the writer)
        self._append_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def create(cls, path: str, fingerprint: str) -> "Journal":
        j = cls(path, fingerprint)
        j._f = open(path, "w", encoding="utf-8")
        j._write(
            {
                "kind": "header",
                "version": JOURNAL_VERSION,
                "fingerprint": fingerprint,
            }
        )
        return j

    @classmethod
    def resume(cls, path: str, fingerprint: str) -> "Journal":
        """Validate the header fingerprint, replay complete records,
        truncate a torn final line, reopen for append."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise InputError(f"cannot resume from {path}: {e}") from e
        lines = raw.split(b"\n")
        if not lines or not lines[0].strip():
            raise JournalMismatch(f"{path}: empty journal, nothing to resume")
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
                f"{path}: journal fingerprint {header.get('fingerprint')!r} "
                f"does not match this run's inputs ({fingerprint!r}); "
                "refusing to resume — rerun without --resume or point it "
                "at the matching journal"
            )
        j = cls(path, fingerprint)
        if len(lines) == 1:  # header only, no trailing newline yet
            good_bytes = len(lines[0])
            body, tail = [], b""
        else:
            good_bytes = len(lines[0]) + 1  # header + newline
            body, tail = lines[1:-1], lines[-1]
        for i, line in enumerate(body):
            if not line.strip():
                good_bytes += len(line) + 1
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict):
                    raise ValueError("record is not an object")
            except ValueError as e:
                # interior damage: the file was not grown append-only,
                # so later records cannot be trusted either
                raise JournalMismatch(
                    f"{path}: corrupt journal record on line {i + 2}: {e}"
                ) from e
            j._index(rec)
            j.replayed += 1
            good_bytes += len(line) + 1
        if tail.strip():
            # no trailing newline: the process died mid-append. Replay
            # the record only if it parses whole; else drop the torn tail.
            try:
                rec = json.loads(tail)
                if not isinstance(rec, dict):
                    raise ValueError("record is not an object")
                j._index(rec)
                j.replayed += 1
                good_bytes += len(tail)  # keep; newline re-added below
            except ValueError:
                j.dropped += 1
        if good_bytes < len(raw):
            with open(path, "r+b") as f:
                f.truncate(good_bytes)
        j._f = open(path, "a", encoding="utf-8")
        if raw[good_bytes - 1 : good_bytes] != b"\n":
            j._f.write("\n")
            j._f.flush()
        return j

    @classmethod
    def open(cls, path: str, fingerprint: str) -> "Journal":
        """``resume`` when the file exists, ``create`` otherwise — the
        ``--journal PATH`` semantics (idempotent across restarts)."""
        if os.path.exists(path):
            return cls.resume(path, fingerprint)
        return cls.create(path, fingerprint)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- records ------------------------------------------------------------

    def _index(self, rec: dict):
        kind = rec.get("kind")
        if kind == "probe" and "count" in rec:
            self.probes[int(rec["count"])] = rec
        elif kind == "scenario" and "key" in rec:
            self.scenarios[str(rec["key"])] = rec

    def _write(self, rec: dict):
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        # chaos crash point: when armed with a `crash` clause, a torn
        # prefix of `line` lands durably and InjectedCrash propagates —
        # exactly the state a mid-append process death leaves behind
        _inject.crash_write(self.inject_site, self._f, line)
        self._f.write(line)
        self._f.flush()
        os.fsync(self._f.fileno())

    def append(self, rec: dict):
        """Index + durably append one completed record. Idempotent per
        probe count / scenario key (re-appending overwrites the index
        entry; the later record wins on the next resume too)."""
        with self._append_lock:
            self._index(rec)
            if self._f is not None:
                # _append_lock is this journal's single-purpose I/O lock;
                # the fsync'd append IS the critical section
                self._write(rec)

    # -- compaction ---------------------------------------------------------

    def rewrite(self, keep_record: Callable[[dict], bool]) -> Dict[str, int]:
        """Atomically rewrite the journal keeping only the header and
        the body records ``keep_record`` retains — checkpoint
        compaction's truncate-the-absorbed-prefix step
        (runtime/checkpoint.py). The rewrite is crash-safe (tmp + fsync
        + ``os.replace``): a death at any point leaves either the old
        complete file or the new complete file, never a blend.
        Unparsable body lines are dropped (they could only exist on a
        file damaged after the fact; ``resume`` would refuse them
        anyway). Returns ``{"kept": n, "dropped": n}``."""
        with self._append_lock:
            if self._f is not None:
                self._f.flush()
            with open(self.path, "rb") as f:
                raw = f.read()
            lines = raw.split(b"\n")
            kept, dropped = 0, 0
            out_lines = [lines[0]]  # header stays verbatim
            for line in lines[1:]:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict):
                        raise ValueError("record is not an object")
                except ValueError:
                    dropped += 1
                    continue
                if keep_record(rec):
                    out_lines.append(line)
                    kept += 1
                else:
                    dropped += 1
            tmp = self.path + ".compact.tmp"
            with open(tmp, "wb") as f:
                f.write(b"\n".join(out_lines) + b"\n")
                f.flush()
                # atomic with respect to concurrent appends: holding the
                # append lock across the fsync is the whole point
                os.fsync(f.fileno())
            reopen = self._f is not None
            if reopen:
                self._f.close()
                self._f = None
            os.replace(tmp, self.path)
            if reopen:
                self._f = open(self.path, "a", encoding="utf-8")
            return {"kept": kept, "dropped": dropped}

    def record_probe(self, rec: dict):
        self.append({**rec, "kind": "probe"})

    def get_probe(self, count: int) -> Optional[dict]:
        return self.probes.get(int(count))

    def record_scenario(self, key: str, rec: dict):
        self.append({**rec, "kind": "scenario", "key": str(key)})

    def get_scenario(self, key: str) -> Optional[dict]:
        return self.scenarios.get(str(key))
