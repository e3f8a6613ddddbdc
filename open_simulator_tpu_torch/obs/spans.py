"""Hierarchical span tracing — the flight recorder's timeline.

The flat ``utils.trace.Trace`` phase timers answer "how long did encode
take in total"; spans answer "where did these 4.4 seconds go, span by
span": every recorded interval carries its parent, so one `simon apply`
run renders as a tree (command root -> probe search -> per-probe scan
-> device dispatch) loadable in Perfetto / chrome://tracing.

Design:

- ONE process-wide ``Recorder`` (``RECORDER``), disabled by default.
  Disabled cost is a single attribute read per ``span()`` entry —
  the hot path pays nothing until ``--trace-out`` (or a test) enables
  it.
- Parent tracking rides a ``contextvars.ContextVar``: each thread (the
  CLI main thread, serve's dispatcher thread, HTTP handler threads)
  gets its own span stack for free, so concurrent requests nest under
  their own roots instead of interleaving.
- ``utils.trace.phase`` is shimmed to emit each phase as a leaf span
  when the recorder is on, so every existing phase annotation joins
  the tree without touching its call sites.
- Exporters: Chrome trace-event JSON (``export_chrome_trace``; complete
  "X" events, microsecond timestamps — Perfetto nests same-thread
  events by time containment) and streaming JSONL (``JsonlSink``; one
  fsync'd line per completed span, the journal append discipline,
  so a crashed run keeps every finished span).

This module is stdlib-only on purpose: ``utils.trace`` imports it at
module load, so it must not pull in anything from the package.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SPAN_SCHEMA_VERSION = 1

# current span id of the calling context (None = root); a ContextVar
# rather than a thread-local so async callers inherit correctly too
_parent: contextvars.ContextVar = contextvars.ContextVar(
    "simon_obs_parent_span", default=None
)

# top-level-span boundary hook (obs/ledger.py: HBM watermark frames).
# A settable slot rather than an import so this module stays
# stdlib-only at load time; obs/profile.py installs the ledger's hook.
# Signature: hook("open", name) -> token; hook("close", name, token).
_BOUNDARY_HOOK = None


def set_boundary_hook(fn) -> None:
    global _BOUNDARY_HOOK
    _BOUNDARY_HOOK = fn


# request-correlation provider (obs/telemetry.py): answers the calling
# context's request ID (or None). A settable slot keeps this module
# stdlib-only; when installed, every recorded span is stamped with a
# `request_id` attr automatically, so a request's whole subtree —
# admission, queue wait, coalesced dispatch, reply — is greppable by
# one ID in any exported trace.
_RID_PROVIDER = None

# dropped-span counter hook (utils/trace.py installs one that feeds
# COUNTERS "spans_dropped_total" and the trace notes): truncation must
# be observable wherever the spans end up
_DROP_HOOK = None


def set_request_id_provider(fn) -> None:
    global _RID_PROVIDER
    _RID_PROVIDER = fn


def set_drop_hook(fn) -> None:
    global _DROP_HOOK
    _DROP_HOOK = fn


def _count_drop(n: int = 1) -> None:
    hook = _DROP_HOOK
    if hook is None:
        return
    try:
        hook(n)
    except Exception:  # noqa: BLE001,S110 - drop accounting must never fail the traced work
        pass


@dataclass
class SpanRecord:
    """One closed span. Times are seconds relative to the recorder's
    enable() epoch (perf_counter domain)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    t0: float
    t1: float
    tid: int
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        out = {
            "kind": "span",
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "t0": round(self.t0, 9),
            "t1": round(self.t1, 9),
            "tid": self.tid,
        }
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class JsonlSink:
    """Streaming JSONL span export with the journal's append
    discipline (runtime/journal.py): one line per record, flushed and
    fsync'd per append, header line first — a crash keeps every span
    that finished before it, and a torn final line is the only possible
    damage."""

    def __init__(self, path: str):
        self.path = path
        # own lock, NOT the recorder's: the fsync must never run under
        # the process-wide span lock (it would serialize every thread's
        # span close behind disk latency — see Recorder.span)
        self._lock = threading.Lock()
        self._f = open(path, "w", encoding="utf-8")
        self._emit(
            {
                "kind": "header",
                "version": SPAN_SCHEMA_VERSION,
                "pid": os.getpid(),
                "clock": "perf_counter-relative-seconds",
            }
        )

    # audited: this lock exists ONLY to keep concurrent appends'
    # write+flush+fsync sequences whole (torn lines are worse than
    # queueing); it is single-purpose, leaf in the lock order, and the
    # recorder deliberately never holds its own lock across emit()
    def _emit(self, rec: dict):  # simonlint: disable=CONC002
        with self._lock:
            if self._f is None:  # closed concurrently (recorder disable)
                return
            self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def emit(self, rec: SpanRecord):
        self._emit(rec.as_dict())

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class Recorder:
    """Process-wide span store. enable()/disable() bracket a recording
    session; spans closing while disabled are dropped silently (a
    thread may still be inside a span when the CLI disables at exit).

    Two overflow postures past ``max_spans``:

    - cap mode (``ring=False``, the one-shot CLI default): newest
      spans drop, the recorded prefix stays intact — a bounded trace
      of how the run STARTED;
    - ring mode (``ring=True``, the resident daemons): the OLDEST span
      is overwritten — a continuous flight recorder whose window is
      always the most recent activity, which is what a live
      ``/debug/dump`` needs.

    Either way every lost span increments ``dropped`` and fires the
    drop hook (COUNTERS ``spans_dropped_total`` + a trace note), so a
    truncated trace is detectable, never silent."""

    # default bound so a pathological run cannot grow the recorder
    # without limit; daemons arm smaller rings (obs/telemetry.py)
    MAX_SPANS = 250_000

    def __init__(self):
        self.enabled = False
        self.ring = False
        self.max_spans = self.MAX_SPANS
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self._ring_pos = 0
        self._next_id = 1
        self.dropped = 0
        self._epoch = 0.0
        self._sink: Optional[JsonlSink] = None

    def enable(self, sink: Optional[JsonlSink] = None):
        with self._lock:
            self._spans = []
            self._ring_pos = 0
            self._next_id = 1
            self.dropped = 0
            self._epoch = time.perf_counter()
            self._sink = sink
            self.enabled = True

    def disable(self):
        with self._lock:
            self.enabled = False
            if self._sink is not None:
                self._sink.close()
                self._sink = None

    def reset(self):
        with self._lock:
            self._spans = []
            self._ring_pos = 0
            self._next_id = 1
            self.dropped = 0

    @property
    def count(self) -> int:
        """Resident span count, O(1) — /metrics and snapshot polls
        must not copy a 100k-span ring just to report its size."""
        with self._lock:
            return len(self._spans)

    def snapshot(self) -> List[SpanRecord]:
        """Recorded spans, oldest first (ring rotation unwound)."""
        with self._lock:
            if self.ring and len(self._spans) == self.max_spans:
                pos = self._ring_pos
                return self._spans[pos:] + self._spans[:pos]
            return list(self._spans)

    # audited: every caller invokes this WITH self._lock held (span's
    # close path and record_span both take it around the call); the
    # helper exists so the cap-vs-ring posture lives in one place
    def _store(self, rec: SpanRecord) -> Optional[JsonlSink]:  # simonlint: disable=CONC001
        """Append one closed span — caller MUST hold self._lock (cap
        vs ring posture); returns the sink to emit to (outside the
        lock), or None. Caller fires the drop hook when `dropped`
        advanced."""
        if len(self._spans) < self.max_spans:
            self._spans.append(rec)
        elif self.ring:
            self._spans[self._ring_pos] = rec
            self._ring_pos = (self._ring_pos + 1) % self.max_spans
            self.dropped += 1
        else:
            self.dropped += 1
            return None
        return self._sink

    @contextmanager
    def span(self, name: str, **attrs):
        """Record the enclosed block as a span under the context's
        current parent. Yields the span id (None when disabled)."""
        # unlocked fast-path read: `enabled` flips rarely (CLI
        # enable/disable brackets) and a stale read only drops or
        # records one span at the boundary — the close path re-checks
        # under the lock before appending
        if not self.enabled:  # simonlint: disable=CONC001
            yield None
            return
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            # epoch snapshot rides the id-allocation lock: enable()
            # resets it concurrently, and t0/t1 must subtract the SAME
            # epoch or the span's duration is garbage
            epoch = self._epoch
        parent = _parent.get()
        rid_fn = _RID_PROVIDER
        if rid_fn is not None and "request_id" not in attrs:
            try:
                rid = rid_fn()
            except Exception:  # noqa: BLE001 - correlation must never fail the traced work
                rid = None
            if rid is not None:
                attrs["request_id"] = rid
        token = _parent.set(sid)
        hook = _BOUNDARY_HOOK if parent is None else None
        hook_token = None
        if hook is not None:
            try:
                hook_token = hook("open", name)
            except Exception:  # noqa: BLE001 - observability must never fail the traced work
                hook = None
        t0 = time.perf_counter()
        try:
            yield sid
        finally:
            t1 = time.perf_counter()
            _parent.reset(token)
            if hook is not None:
                try:
                    hook("close", name, hook_token)
                except Exception:  # noqa: BLE001,S110 - watermark bookkeeping must never fail (or mask an exception from) the traced work; the open-side hook already disarms itself on error
                    pass
            rec = SpanRecord(
                span_id=sid,
                parent_id=parent,
                name=name,
                t0=t0 - epoch,
                t1=t1 - epoch,
                tid=threading.get_ident(),
                attrs=attrs,
            )
            with self._lock:
                # disabled mid-span: drop, don't resurrect. NOT an
                # early return — a `return` inside this finally would
                # swallow any in-flight exception from the span body
                # (contextlib reads the generator's clean exit as
                # "exception suppressed")
                if self.enabled:
                    before = self.dropped
                    sink = self._store(rec)
                    dropped = self.dropped - before
                else:
                    sink, dropped = None, 0
            if dropped:
                _count_drop(dropped)
            # sink I/O (write+flush+fsync) happens OUTSIDE the recorder
            # lock: concurrent threads closing spans must not queue
            # behind each other's disk syncs. The sink's own lock keeps
            # lines whole; a close() racing in from disable() makes the
            # emit a no-op (the span stays in the in-memory snapshot)
            if sink is not None:
                sink.emit(rec)

    def record_span(
        self,
        name: str,
        t0: float,
        t1: float,
        parent_id: Optional[int] = None,
        tid: Optional[int] = None,
        **attrs,
    ) -> Optional[int]:
        """Append one span with EXPLICIT perf_counter timestamps —
        how the coalescer synthesizes per-request subtrees (queue_wait
        / evaluate) from timings it already measured, instead of
        wrapping work that happened for a whole batch at once. Returns
        the span id (None when disabled) so children can attach."""
        # unlocked fast-path read, same contract as span(): a stale
        # read at the enable/disable boundary loses at most one span,
        # and the store path re-checks under the lock
        if not self.enabled:  # simonlint: disable=CONC001
            return None
        rid_fn = _RID_PROVIDER
        if rid_fn is not None and "request_id" not in attrs:
            try:
                rid = rid_fn()
            except Exception:  # noqa: BLE001 - correlation must never fail the recording
                rid = None
            if rid is not None:
                attrs["request_id"] = rid
        with self._lock:
            if not self.enabled:
                return None
            sid = self._next_id
            self._next_id += 1
            epoch = self._epoch
            rec = SpanRecord(
                span_id=sid,
                parent_id=parent_id,
                name=name,
                t0=t0 - epoch,
                t1=t1 - epoch,
                tid=tid if tid is not None else threading.get_ident(),
                attrs=attrs,
            )
            before = self.dropped
            sink = self._store(rec)
            dropped = self.dropped - before
        if dropped:
            _count_drop(dropped)
        if sink is not None:
            sink.emit(rec)
        return sid

RECORDER = Recorder()


def span(name: str, **attrs):
    """Module-level convenience: ``with span("apply/plan"): ...``"""
    return RECORDER.span(name, **attrs)


def traced(name: Optional[str] = None, **attrs):
    """Decorator form: record every call of the function as a span."""

    def deco(fn):
        import functools

        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not RECORDER.enabled:
                return fn(*args, **kwargs)
            with RECORDER.span(label, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# ------------------------------------------------------------- exporters


def export_chrome_trace(path: str, spans: Optional[List[SpanRecord]] = None):
    """Write the recorded spans as Chrome trace-event JSON (the
    ``traceEvents`` array of complete "X" events), loadable in Perfetto
    or chrome://tracing. Same-thread events nest by time containment,
    which the parent-tracked spans satisfy by construction."""
    if spans is None:
        spans = RECORDER.snapshot()
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": os.getpid(),
            "tid": 0,
            "args": {"name": "simon"},
        }
    ]
    for s in spans:
        args = {"span_id": s.span_id}
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        args.update(s.attrs)
        events.append(
            {
                "name": s.name,
                "cat": "simon",
                "ph": "X",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
                "pid": os.getpid(),
                "tid": s.tid,
                "args": args,
            }
        )
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    observatory = observatory_block()
    if observatory:
        doc["simonObservatory"] = observatory
    if RECORDER.dropped:
        # truncation is part of the artifact: validate_trace flags it,
        # and a reader knows the forest is a window, not the whole run
        doc["simonSpansDropped"] = {
            "dropped": RECORDER.dropped,
            "mode": "ring" if RECORDER.ring else "cap",
            "maxSpans": RECORDER.max_spans,
        }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


def observatory_block() -> dict:
    """The cost-record / memory-ledger / histogram snapshot attached to
    trace artifacts, in the JAX package's shape but for `costs`, whose
    records are the port's (obs/costs.py CostRecord), and for
    `aot_store`, whose entries are kernel libraries
    (incremental/store.py). Lazy sibling imports keep this module
    stdlib-only at load time."""
    from ..incremental.store import aot_store_block, incremental_block
    from . import profile
    from .costs import COSTS
    from .histo import HISTOS
    from .ledger import LEDGER

    # the device times of card launches the caller has synchronised
    profile.resolve_pending(wait=True)
    out = {}
    costs = COSTS.summary()
    if costs:
        out["costs"] = costs
    ledger = LEDGER.summary()
    if ledger.get("samples"):
        out["ledger"] = ledger
    # buckets included: tools/validate_trace.py cross-checks bucket
    # sums against counts
    histos = HISTOS.summary(with_buckets=True)
    if histos:
        out["histograms"] = histos
    per_device = LEDGER.device_summary()
    if per_device:
        out["per_device"] = per_device
    # delta re-simulation and kernel-library store counters
    # (incremental/): suffix_fraction and hit_rate are doctor-gated
    # dimensions (obs/doctor.py)
    inc = incremental_block()
    if inc:
        out["incremental"] = inc
    store = aot_store_block()
    if store:
        out["aot_store"] = store
    if RECORDER.dropped:
        out["spans_dropped"] = RECORDER.dropped
    return out


def export_jsonl(path: str, spans: Optional[List[SpanRecord]] = None):
    """One-shot JSONL dump of recorded spans (the streaming form is
    ``JsonlSink`` passed to ``Recorder.enable``)."""
    if spans is None:
        spans = RECORDER.snapshot()
    sink = JsonlSink(path)
    try:
        for s in spans:
            sink.emit(s)
    finally:
        sink.close()


# ------------------------------------------------------------- analysis


def nesting_depth(spans: List[SpanRecord]) -> int:
    """Maximum depth of the span forest (roots are depth 1)."""
    by_id = {s.span_id: s for s in spans}
    best = 0
    for s in spans:
        d, cur = 1, s
        while cur.parent_id is not None and cur.parent_id in by_id:
            cur = by_id[cur.parent_id]
            d += 1
        best = max(best, d)
    return best


def exclusive_times(spans: List[SpanRecord]) -> Dict[str, float]:
    """Per-span-NAME exclusive wall-clock: each span's duration minus
    the durations of its direct children (self-time), summed per name.
    The bench's "top spans" attribution reads this — a parent phase
    that merely contains an expensive child stops looking expensive."""
    child_sum: Dict[int, float] = {}
    for s in spans:
        if s.parent_id is not None:
            child_sum[s.parent_id] = child_sum.get(s.parent_id, 0.0) + s.duration
    out: Dict[str, float] = {}
    for s in spans:
        excl = max(s.duration - child_sum.get(s.span_id, 0.0), 0.0)
        out[s.name] = out.get(s.name, 0.0) + excl
    return out


def top_spans(spans: List[SpanRecord], k: int = 5) -> List[dict]:
    """Top-k span names by exclusive time, for machine-readable
    reports (bench metrics, docs)."""
    excl = exclusive_times(spans)
    ranked = sorted(excl.items(), key=lambda kv: -kv[1])[:k]
    return [
        {"name": name, "exclusive_ms": round(sec * 1e3, 3)}
        for name, sec in ranked
    ]


# cached hot-span table for /metrics: with the daemons' always-armed
# ring, an uncached read would copy the (up to 100k-span) ring and walk
# it on EVERY scrape — stalling concurrent span closes behind the
# recorder lock for the copy's duration. The cache is a benign-race
# dict: worst case two scrapes both recompute one window.
_TOP_CACHE = {"t": -1e18, "top": []}
TOP_SPANS_CACHE_S = 30.0


def top_spans_cached(k: int = 5, max_age_s: float = TOP_SPANS_CACHE_S) -> List[dict]:
    """`top_spans` over the live recorder, recomputed at most once per
    ``max_age_s`` — the /metrics exposition's bounded-cost accessor."""
    now = time.monotonic()
    if now - _TOP_CACHE["t"] < max_age_s:
        return _TOP_CACHE["top"]
    top = top_spans(RECORDER.snapshot(), k)
    _TOP_CACHE["top"] = top
    _TOP_CACHE["t"] = now
    return top
