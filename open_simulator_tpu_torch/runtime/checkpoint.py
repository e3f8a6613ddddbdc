"""Bounded-recovery checkpoints: verified, content-addressed state
snapshots + journal compaction for the resident daemons.

The port's copy of the JAX package's runtime/checkpoint.py: the same
file format and toolchain digest, so a checkpoint written by either
package restores in the other.

The delta journals made a daemon's warm state durable, but
recovery cost grew with LIFETIME: a replica that absorbed 500k cluster
deltas replayed all 500k on respawn. This module bounds recovery by
RECENCY instead — a daemon's durable state becomes a chain of verified
snapshots plus a compacted journal suffix, and a replacement replays
only the deltas since the last good checkpoint:

- **Generation files** live in a directory next to the snapshot
  journal (``<snapshot>.ckpt/``), one two-line JSONL file per
  checkpoint named ``gen-<deltaSeq>-<sha12>.ckpt`` (content-addressed:
  the name carries the payload digest prefix). Line 1 is the header —
  format/version/toolchain, the daemon's ``/v1/state-digest`` triple
  (``fingerprint``/``deltaSeq``/``stateDigest``), and the sha256 of
  the payload line; line 2 is the payload. Writes are crash-safe
  (tmp + fsync + ``os.replace``): a process death mid-write leaves
  only an ignorable tmp file, never a torn generation.

- **Verification precedes trust.** A checkpoint is only USED after the
  payload line re-hashes to the header sha256 AND (on the write path)
  the payload re-materializes to the recorded ``stateDigest`` through
  the owner's warm==cold conformance machinery. Journal compaction
  truncates the replayed prefix only AFTER that verification — a
  checkpoint that cannot be proven equivalent to the live state never
  costs journal history.

- **Retained generations** (``--keep-checkpoints N``): restore walks
  newest → oldest; a torn/corrupt/stale generation is refused LOUDLY
  (``CheckpointMismatch``, ``ckpt_restore_fallback_total``) and the
  previous generation restores with a longer journal suffix — never a
  silent wrong state. Compaction is therefore bounded by the OLDEST
  retained generation, so every retained generation still has its full
  delta suffix in the journal. When every generation is refused,
  recovery degrades to the full-journal replay (the pre-checkpoint
  posture).

Fault-injection seams (runtime/inject.py):

- ``ckpt.write`` — fired once per attempt, plus the ``crash_write``
  point on the payload line (a ``crash`` clause with ``@2`` tears the
  tmp file mid-fsync; ``@1`` dies before any byte lands).
- ``ckpt.verify`` — fired before the fresh-materialization check.
- ``ckpt.compact`` — fired after a verified write, before the journal
  rewrite: a crash here leaves the journal untouched, and the
  seq-filtered replay stays correct over the un-truncated file.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..utils.trace import COUNTERS
from . import inject as _inject
from .journal import JOURNAL_VERSION, JournalMismatch, config_fingerprint

log = logging.getLogger("simon.ckpt")

CHECKPOINT_VERSION = 1

#: default retained-generation count (--keep-checkpoints)
DEFAULT_KEEP = 2

#: generation file name: delta seq (zero-padded, lexicographic order ==
#: numeric order) + the first 12 hex chars of the payload sha256
_GEN_RE = re.compile(r"^gen-(\d{10})-([0-9a-f]{12})\.ckpt$")


class CheckpointMismatch(JournalMismatch):
    """A checkpoint generation cannot be trusted — torn payload, digest
    mismatch, stale toolchain, or a foreign fingerprint. Refused loudly;
    the caller falls back to the previous generation (longer replay),
    never to a silently wrong state."""


def toolchain_digest() -> str:
    """Digest of everything that shapes the checkpoint format and the
    journal discipline it compacts. Deliberately LIGHTWEIGHT (it names
    no compiler and imports no device stack): a checkpoint must be
    loadable before the card warms, and restore identity is proven by
    the state digest, not by compiler versions. Equal in both packages."""
    return config_fingerprint(
        {
            "format": "simon-checkpoint",
            "version": CHECKPOINT_VERSION,
            "journal": JOURNAL_VERSION,
        }
    )


def checkpoint_dir(snapshot_path: str) -> str:
    """The generation directory for a snapshot journal path."""
    return snapshot_path + ".ckpt"


@dataclass
class CheckpointState:
    """One captured daemon state: the ``/v1/state-digest`` triple plus
    the JSON payload a restore re-materializes from."""

    fingerprint: str
    delta_seq: int
    state_digest: str
    payload: dict


def _fsync_dir(directory: str):
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds; rename is still atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_checkpoint(
    directory: str, state: CheckpointState, toolchain: Optional[str] = None
) -> str:
    """Durably write one generation file (tmp + fsync + rename).
    Returns the final path. The ``ckpt.write`` seam fires first; the
    payload line additionally passes the ``crash_write`` point, so an
    armed crash clause leaves exactly the torn-tmp state a real
    mid-fsync death would."""
    _inject.fire("ckpt.write", seq=state.delta_seq)
    os.makedirs(directory, exist_ok=True)
    payload_line = (
        json.dumps(state.payload, sort_keys=True, separators=(",", ":")) + "\n"
    )
    sha = hashlib.sha256(payload_line.encode("utf-8")).hexdigest()
    header = {
        "kind": "checkpoint",
        "version": CHECKPOINT_VERSION,
        "toolchain": toolchain or toolchain_digest(),
        "fingerprint": state.fingerprint,
        "deltaSeq": int(state.delta_seq),
        "stateDigest": state.state_digest,
        "sha256": sha,
    }
    name = f"gen-{int(state.delta_seq):010d}-{sha[:12]}.ckpt"
    final = os.path.join(directory, name)
    tmp = os.path.join(directory, f".{name}.tmp")
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(header, sort_keys=True, separators=(",", ":")))
            f.write("\n")
            _inject.crash_write("ckpt.write", f, payload_line)
            f.write(payload_line)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except Exception:  # noqa: BLE001 - cleanup-and-reraise: nothing is swallowed
        # a failed attempt must not leave tmp litter behind (a crash
        # fault is BaseException and skips this — exactly a real death)
        try:
            os.unlink(tmp)
        except OSError:  # noqa: S110 - tmp may never have been created
            pass
        raise
    _fsync_dir(directory)
    return final


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """``(delta_seq, path)`` for every generation file, newest (highest
    seq) first. Tmp litter and foreign names are ignored."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _GEN_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def load_checkpoint(
    path: str,
    expect_fingerprint: Optional[str] = None,
    expect_toolchain: Optional[str] = None,
) -> Tuple[dict, dict]:
    """Read and validate one generation file -> (header, payload).
    Every way a generation can be untrustworthy — unreadable, torn,
    wrong format/version, stale toolchain, foreign fingerprint, payload
    bytes not matching the header sha256 — raises CheckpointMismatch.
    The sha256 check runs BEFORE the payload is deserialized."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointMismatch(f"cannot read checkpoint {path}: {e}") from e
    parts = raw.split(b"\n", 1)
    if len(parts) != 2 or not parts[0].strip():
        raise CheckpointMismatch(f"{path}: torn checkpoint (no payload line)")
    try:
        header = json.loads(parts[0])
        if not isinstance(header, dict):
            raise ValueError("header is not an object")
    except ValueError as e:
        raise CheckpointMismatch(f"{path}: unreadable checkpoint header: {e}") from e
    if header.get("kind") != "checkpoint":
        raise CheckpointMismatch(f"{path}: first line is not a checkpoint header")
    if header.get("version") != CHECKPOINT_VERSION:
        raise CheckpointMismatch(
            f"{path}: checkpoint version {header.get('version')!r} != "
            f"{CHECKPOINT_VERSION}"
        )
    tool = expect_toolchain or toolchain_digest()
    if header.get("toolchain") != tool:
        raise CheckpointMismatch(
            f"{path}: checkpoint toolchain {header.get('toolchain')!r} does "
            f"not match this build ({tool!r}); a stale-format snapshot must "
            "not restore silently"
        )
    if expect_fingerprint is not None and header.get("fingerprint") != expect_fingerprint:
        raise CheckpointMismatch(
            f"{path}: checkpoint fingerprint {header.get('fingerprint')!r} "
            f"does not match this daemon's cluster ({expect_fingerprint!r})"
        )
    payload_line = parts[1]
    sha = hashlib.sha256(payload_line).hexdigest()
    if sha != header.get("sha256"):
        raise CheckpointMismatch(
            f"{path}: payload sha256 {sha[:12]}... does not match the header "
            f"({str(header.get('sha256'))[:12]}...); torn or corrupt snapshot"
        )
    try:
        payload = json.loads(payload_line)
        if not isinstance(payload, dict):
            raise ValueError("payload is not an object")
    except ValueError as e:  # pragma: no cover - sha passed, parse cannot fail
        raise CheckpointMismatch(f"{path}: unreadable payload: {e}") from e
    return header, payload


def prune_checkpoints(directory: str, keep: int) -> List[str]:
    """Drop the oldest generations past ``keep`` (and any stale tmp
    litter from crashed writes). Returns the removed paths."""
    removed = []
    for _seq, path in list_checkpoints(directory)[max(1, int(keep)):]:
        try:
            os.unlink(path)
            removed.append(path)
        except OSError:
            log.debug("checkpoint %s vanished under prune", path)
    try:
        for name in os.listdir(directory):
            if name.startswith(".") and name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    log.debug("tmp litter %s vanished under prune", name)
    except OSError:
        log.debug("checkpoint dir %s unreadable during tmp sweep", directory)
    if removed:
        COUNTERS.inc("ckpt_pruned_total", len(removed))
    return removed


class CheckpointManager:
    """Periodic checkpoint + compaction manager for one daemon.

    The owner provides three callables:

    - ``capture()`` -> CheckpointState: the committed state under the
      owner's consistency lock (the state-digest triple + payload).
    - ``materialized_digest(payload)`` -> str: the state digest of a
      FRESH materialization of the payload (the warm==cold
      conformance machinery) — what the verify step compares against
      the captured digest before any journal history is truncated.
    - ``keep_record(rec, upto_seq)`` -> bool (optional, with a
      ``journal``): the compaction predicate — True retains the
      journal record, False drops it as absorbed by the checkpoint.

    ``note_delta(seq)`` is the hot-path hook: an integer compare and an
    event set; the checkpoint itself runs on a background worker
    (``synchronous=True`` runs it inline — tests and drains). Write and
    verify failures are counted + logged and surface as degraded
    reasons; they never kill the daemon — the cost of a failed
    checkpoint is recovery time, not correctness."""

    def __init__(
        self,
        directory: str,
        *,
        interval: int,
        keep: int = DEFAULT_KEEP,
        capture: Callable[[], Optional[CheckpointState]],
        materialized_digest: Callable[[dict], str],
        journal=None,
        keep_record: Optional[Callable[[dict, int], bool]] = None,
        label: str = "serve",
        synchronous: bool = False,
    ):
        from ..models.validation import InputError

        if int(interval) < 1:
            raise InputError(
                f"--checkpoint-interval must be >= 1 delta, got {interval}"
            )
        if int(keep) < 1:
            raise InputError(f"--keep-checkpoints must be >= 1, got {keep}")
        self.directory = directory
        self.interval = int(interval)
        self.keep = int(keep)
        self.capture = capture
        self.materialized_digest = materialized_digest
        self.journal = journal
        self.keep_record = keep_record
        self.label = label
        self.synchronous = bool(synchronous)
        self.last_seq = 0
        self.last_error: Optional[str] = None
        self.writes = 0
        self.compactions = 0
        self._trigger = threading.Event()
        self._stopped = threading.Event()
        self._op_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self.synchronous or self._worker is not None:
            return
        self._worker = threading.Thread(
            target=self._run, name=f"simon-ckpt-{self.label}", daemon=True
        )
        self._worker.start()

    def stop(self):
        self._stopped.set()
        self._trigger.set()
        if self._worker is not None:
            self._worker.join(timeout=10.0)
            self._worker = None

    def note_restored(self, seq: int):
        """A bootstrap restored generation ``seq``: the next checkpoint
        is due one full interval later, not immediately."""
        self.last_seq = max(self.last_seq, int(seq))

    # -- the hot-path hook ---------------------------------------------------

    def note_delta(self, seq: int):
        """Called after each journaled delta; cheap by contract (an int
        compare; the snapshot write runs off the hot path)."""
        if seq - self.last_seq < self.interval:
            return
        if self.synchronous:
            self.run_once()
        else:
            self._trigger.set()

    def _run(self):
        while not self._stopped.is_set():
            self._trigger.wait()
            self._trigger.clear()
            if self._stopped.is_set():
                return
            self.run_once()

    def run_once(self) -> Optional[str]:
        """One guarded checkpoint attempt: failures are counted, logged
        and surfaced via ``degraded_reasons`` — never raised (a crash
        fault, being BaseException, still propagates like a real
        death). Returns the generation path on success."""
        try:
            return self.checkpoint_now()
        except Exception as e:  # noqa: BLE001 - degraded, surfaced, never fatal
            COUNTERS.inc("ckpt_write_errors_total")
            self.last_error = f"{type(e).__name__}: {e}"
            log.warning(
                "%s checkpoint failed (previous generation remains "
                "authoritative): %s", self.label, self.last_error,
            )
            return None

    # -- the checkpoint ladder -----------------------------------------------

    def checkpoint_now(self) -> Optional[str]:
        """capture -> write -> verify -> rotate -> compact. Raises on
        write/verify failure (``run_once`` wraps this for the daemon
        path). The journal is compacted only after the written
        generation's digest verified against a fresh materialization."""
        with self._op_lock:
            state = self.capture()
            if state is None or int(state.delta_seq) <= self.last_seq:
                return None
            t0 = time.perf_counter()
            # _op_lock is this manager's single-purpose lock serializing
            # checkpoint attempts; the fsync'd write IS the critical
            # section (same audited shape as JsonlSink._emit)
            path = write_checkpoint(self.directory, state)  # simonlint: disable=CONC002
            try:
                _inject.fire("ckpt.verify", path=path, seq=state.delta_seq)
                header, payload = load_checkpoint(
                    path, expect_fingerprint=state.fingerprint
                )
                fresh = self.materialized_digest(payload)
                if fresh != header["stateDigest"]:
                    raise CheckpointMismatch(
                        f"{path}: fresh materialization digest {fresh!r} != "
                        f"captured state digest {header['stateDigest']!r}; "
                        "refusing to trust (or compact against) this snapshot"
                    )
            except Exception:  # noqa: BLE001 - count, drop the bad file, reraise
                COUNTERS.inc("ckpt_verify_failures_total")
                try:
                    os.unlink(path)
                except OSError:  # noqa: S110 - generation already gone is fine
                    pass
                raise
            self.last_seq = int(state.delta_seq)
            self.writes += 1
            self.last_error = None
            COUNTERS.inc("ckpt_writes_total")
            COUNTERS.gauge(f"ckpt_last_seq_{self.label}", float(self.last_seq))
            COUNTERS.gauge(
                "ckpt_write_seconds", round(time.perf_counter() - t0, 6)
            )
            prune_checkpoints(self.directory, self.keep)
            # compact only up to the OLDEST retained generation: every
            # retained generation must keep its full journal suffix, so
            # a corrupt newest checkpoint can fall back to the previous
            # one + a LONGER replay without losing deltas
            retained = list_checkpoints(self.directory)
            if retained:
                self._compact(retained[-1][0])
            return path

    def _compact(self, upto_seq: int):
        """Truncate the journal prefix absorbed by EVERY retained
        generation (the caller passes the oldest one's seq). The
        ``ckpt.compact`` seam fires BEFORE the rewrite: a crash (or
        injected fault) here leaves the journal whole, and restore's
        seq filter keeps the un-truncated replay correct. A compaction
        failure degrades (counted), never un-verifies the snapshot."""
        if self.journal is None or self.keep_record is None:
            return
        try:
            _inject.fire("ckpt.compact", seq=upto_seq)
            out = self.journal.rewrite(
                lambda rec: self.keep_record(rec, upto_seq)
            )
        except Exception as e:  # noqa: BLE001 - degraded, surfaced, never fatal
            COUNTERS.inc("ckpt_compact_errors_total")
            self.last_error = f"compaction: {type(e).__name__}: {e}"
            log.warning(
                "%s journal compaction failed (journal intact; replay "
                "still bounded by the checkpoint's seq filter): %s",
                self.label, e,
            )
            return
        self.compactions += 1
        COUNTERS.inc("ckpt_compactions_total")
        COUNTERS.inc("ckpt_compacted_records_total", out["dropped"])

    # -- observability -------------------------------------------------------

    def degraded_reasons(self) -> List[str]:
        if self.last_error:
            return [
                f"checkpoint degraded: {self.last_error} "
                "(see ckpt_write_errors_total / ckpt_compact_errors_total)"
            ]
        return []

    def stats(self) -> dict:
        return {
            "interval": self.interval,
            "keep": self.keep,
            "lastSeq": self.last_seq,
            "writes": self.writes,
            "compactions": self.compactions,
            "generations": len(list_checkpoints(self.directory)),
            "lastError": self.last_error,
        }
