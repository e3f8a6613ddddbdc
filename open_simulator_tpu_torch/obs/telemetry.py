"""Production telemetry: request correlation + the resident series store.

The port's copy of the JAX package's obs/telemetry.py; the sampler
reads the port's registries (``COUNTERS``, ``obs/histo.HISTOS``,
``obs/ledger.LEDGER``) and the debug dump counts launches and nvcc
builds where the JAX one counts dispatches and recompiles.

A resident daemon (serve) with batch-shaped observability: spans dump at exit, ``/metrics``
exports only instantaneous values, and a request that joins a coalesced
dispatch loses its identity. This module is the telemetry layer a
production scheduler assumes:

- **Request correlation**: every request carries an ID — accepted from
  the ``X-Simon-Request-Id`` header (sanitized), else minted — held in
  a ``contextvars.ContextVar`` so every span recorded while handling
  the request is stamped with it automatically (obs/spans.py asks this
  module through a provider hook). The coalescer synthesizes
  per-request span subtrees (queue_wait / evaluate) from measured
  timestamps, so a batch of N requests yields N traceable subtrees at
  zero extra device work.
- **Resident time-series store** (``SERIES``): a fixed-size ring per
  signal — O(1) append, bounded memory — with seeded-DETERMINISTIC
  downsampling into coarser rings (each bucket of ``AGG`` points keeps
  one hash-chosen representative plus the bucket min/max/mean), so a
  daemon holds hours of history in a few MB and two runs with the same
  samples downsample identically. ``TelemetryRuntime`` samples every
  ``Counters`` counter/gauge, histogram percentile, and ledger
  watermark on a cadence, and drives the SLO engine (obs/slo.py).
- **Query surface**: ``/v1/obs/series`` + ``/v1/obs/snapshot`` on the
  serve and twin daemons (`simon top` renders them live), and
  ``POST /debug/dump`` — a spans+series+SLO snapshot from a live
  daemon, shaped so ``simon doctor`` can diff two dumps.

Stdlib-only at import time on purpose: ``obs.spans`` must stay
importable from ``utils.trace`` without cycles, so everything that
touches the counter/histogram/ledger registries imports lazily.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import re
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from . import spans as _spans

# ---------------------------------------------------------------- request ids

REQUEST_ID_HEADER = "X-Simon-Request-Id"
#: charset a caller-supplied ID must fit (counter/label/JSON-safe); a
#: non-conforming character is replaced, never rejected — the caller's
#: correlation still works as long as their ID was sane
_RID_RE = re.compile(r"[^A-Za-z0-9_.:-]")
MAX_REQUEST_ID_LEN = 128

_request_id: contextvars.ContextVar = contextvars.ContextVar(
    "simon_request_id", default=None
)


def new_request_id() -> str:
    """Mint a request ID: 16 hex chars of a UUID4, ``req-`` prefixed
    so generated IDs are distinguishable from caller-supplied ones."""
    return "req-" + uuid.uuid4().hex[:16]


def sanitize_request_id(raw: Optional[str]) -> Optional[str]:
    """A header value as a safe ID, or None when absent/empty."""
    if not raw:
        return None
    rid = _RID_RE.sub("_", str(raw))[:MAX_REQUEST_ID_LEN]
    return rid or None


def ensure_request_id(raw: Optional[str] = None) -> str:
    """The caller-supplied ID when one came in, else a fresh one."""
    return sanitize_request_id(raw) or new_request_id()


def current_request_id() -> Optional[str]:
    return _request_id.get()


@contextmanager
def request_scope(rid: str):
    """Bind ``rid`` as the context's request ID: every span recorded
    inside (on this thread / context) is stamped with it."""
    token = _request_id.set(rid)
    try:
        yield rid
    finally:
        _request_id.reset(token)


# spans recorded anywhere in a request scope carry the ID — the hook
# keeps obs/spans.py stdlib-only and cycle-free
_spans.set_request_id_provider(current_request_id)


# ------------------------------------------------------------- trace context

#: cross-process trace propagation (fleet router -> replica): the
#: router stamps its forward span's id plus the fleet hop count on
#: every forwarded request; the replica records the id as a
#: ``remote_parent`` ATTRIBUTE on its ``serve/request`` root (span ids
#: are process-local, so a remote parent can never be a structural
#: ``parent_id`` — the stitcher in fleet/trace.py remaps both id
#: spaces into one tree). Format: ``parent=<span_id>;hop=<n>``.
TRACE_CONTEXT_HEADER = "X-Simon-Trace-Context"
#: hop ceiling: a forwarded request that has already crossed this many
#: fleet hops is parsed as context-free (a loop or a forged header
#: must not grow unbounded attrs)
MAX_TRACE_HOPS = 8

_TRACE_CTX_RE = re.compile(r"^parent=(\d{1,19});hop=(\d{1,3})$")


def format_trace_context(parent_span_id: int, hop: int = 1) -> str:
    """Header value carrying the router-side parent span id and the
    fleet hop count of the receiving process."""
    return f"parent={int(parent_span_id)};hop={int(hop)}"


def parse_trace_context(raw: Optional[str]) -> tuple:
    """``(parent_span_id, hop)`` from a header value, or ``(None, 0)``
    on absence or ANY malformation — a garbled trace context degrades
    to an uncorrelated request, it never fails the request."""
    if not raw:
        return None, 0
    m = _TRACE_CTX_RE.match(str(raw).strip())
    if m is None:
        return None, 0
    parent, hop = int(m.group(1)), int(m.group(2))
    if hop < 1 or hop > MAX_TRACE_HOPS:
        return None, 0
    return parent, hop


# ---------------------------------------------------------------- series ring


#: raw points folded into one coarser point per AGG appends
AGG = 8
#: ring levels: raw, x8, x64 — at a 1s cadence that is ~8.5 min of raw
#: history, ~68 min at x8, ~9 h at x64, in (cap x levels) slots total
LEVELS = 3
DEFAULT_CAPACITY = 512
#: distinct series a store will hold; a label-cardinality accident in
#: the counter registry must not grow the resident set without bound
MAX_SERIES = 4096

RESOLUTIONS = tuple(AGG ** lvl for lvl in range(LEVELS))  # (1, 8, 64)


def _pick_index(seed: int, name: str, level: int, bucket_seq: int) -> int:
    """The seeded-deterministic representative choice: which of the
    AGG points in one downsample bucket survives into the coarser
    ring. A hash, not a PRNG stream: two runs sampling the same series
    pick the same representatives regardless of sampling interleaving
    across series."""
    digest = hashlib.sha256(
        f"{seed}:{name}:{level}:{bucket_seq}".encode()
    ).hexdigest()
    return int(digest[:8], 16) % AGG


class _Ring:
    """Fixed-capacity point ring: O(1) append overwrites the oldest.
    Points are [t, value, vmin, vmax] rows (raw rows carry
    vmin == vmax == value)."""

    __slots__ = ("cap", "rows", "head", "count")

    def __init__(self, cap: int):
        self.cap = cap
        self.rows: List[Optional[list]] = [None] * cap
        self.head = 0  # next write slot
        self.count = 0

    def append(self, row: list) -> None:
        self.rows[self.head] = row
        self.head = (self.head + 1) % self.cap
        if self.count < self.cap:
            self.count += 1

    def points(self) -> List[list]:
        """Chronological copy (oldest first)."""
        if self.count < self.cap:
            return [r for r in self.rows[: self.count]]
        return [
            self.rows[(self.head + i) % self.cap] for i in range(self.cap)
        ]

    def last(self) -> Optional[list]:
        if not self.count:
            return None
        return self.rows[(self.head - 1) % self.cap]


class _Series:
    """One named signal across every resolution level, plus the
    in-progress downsample buckets between levels."""

    __slots__ = ("rings", "pending", "bucket_seq")

    def __init__(self, cap: int):
        self.rings = [_Ring(cap) for _ in range(LEVELS)]
        # pending[lvl] accumulates rows awaiting the fold into lvl+1
        self.pending: List[List[list]] = [[] for _ in range(LEVELS - 1)]
        self.bucket_seq = [0] * (LEVELS - 1)


class SeriesStore:
    """Process-wide name -> ring-set map. ``record`` is the sampler's
    hot path: one lock, one O(1) append, and (every AGG appends per
    level) one O(AGG) fold."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, seed: int = 0):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._seed = seed
        self._series: Dict[str, _Series] = {}
        self._overflowed = 0

    # -- write --------------------------------------------------------------

    def record(self, name: str, t: float, value: float) -> None:
        row = [t, float(value), float(value), float(value)]
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= MAX_SERIES:
                    self._overflowed += 1
                    return
                s = self._series[name] = _Series(self._capacity)
            self._record_level(name, s, 0, row)

    # audited: record() invokes this (and it recurses) WITH self._lock
    # held — the fold must be atomic with the raw append
    def _record_level(self, name, s, level, row):  # simonlint: disable=CONC001
        # caller holds the lock; recursion depth is LEVELS (3)
        s.rings[level].append(row)
        if level >= LEVELS - 1:
            return
        pend = s.pending[level]
        pend.append(row)
        if len(pend) < AGG:
            return
        seq = s.bucket_seq[level]
        s.bucket_seq[level] = seq + 1
        keep = pend[_pick_index(self._seed, name, level, seq)]
        folded = [
            pend[-1][0],  # bucket closes at its newest sample's time
            keep[1],
            min(r[2] for r in pend),
            max(r[3] for r in pend),
        ]
        s.pending[level] = []
        self._record_level(name, s, level + 1, folded)

    # -- read ---------------------------------------------------------------

    def names(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(n for n in self._series if n.startswith(prefix))

    def query(
        self,
        name: str,
        *,
        resolution: int = 1,
        since_s: Optional[float] = None,
        now: Optional[float] = None,
        max_points: Optional[int] = None,
    ) -> List[list]:
        """Chronological [t, value, vmin, vmax] rows of one series at
        one resolution (1, 8, or 64 raw-cadence steps per point)."""
        from ..models.validation import InputError

        try:
            level = RESOLUTIONS.index(int(resolution))
        except ValueError:
            raise InputError(
                f"unknown resolution {resolution!r}; pick one of "
                f"{list(RESOLUTIONS)}"
            ) from None
        with self._lock:
            s = self._series.get(name)
            pts = s.rings[level].points() if s is not None else []
        if since_s is not None:
            cutoff = (now if now is not None else time.time()) - since_s
            pts = [p for p in pts if p[0] >= cutoff]
        if max_points is not None and len(pts) > max_points:
            pts = pts[-max_points:]
        return pts

    def last(self, name: str) -> Optional[list]:
        with self._lock:
            s = self._series.get(name)
            return None if s is None else s.rings[0].last()

    # -- derived reads (the SLO engine's vocabulary) ------------------------

    def window(
        self,
        name: str,
        window_s: float,
        now: Optional[float] = None,
        anchor: bool = False,
    ) -> List[list]:
        """Rows inside the trailing window, read from the FINEST
        resolution whose retained history still covers the whole
        window — a 1 h slow window on a 1 s cadence overflows the raw
        ring (~512 s) and must fall back to the ×8/×64 rings instead
        of silently evaluating the last few minutes as if they were
        the hour. With ``anchor=True`` the newest pre-window row is
        prepended (cumulative-counter deltas anchor at the window edge
        instead of losing the oldest increment); fraction reads leave
        it off — a stale out-of-window sample must not count toward a
        window's bad ratio."""
        now = time.time() if now is None else now
        cutoff = now - window_s
        pts: List[list] = []
        for resolution in RESOLUTIONS:
            level_pts = self.query(name, resolution=resolution)
            if not level_pts:
                continue
            if level_pts[0][0] <= cutoff:
                pts = level_pts
                break  # finest level retaining the whole window
            if not pts or level_pts[0][0] < pts[0][0]:
                # no full coverage yet: remember the level reaching
                # furthest back (a window longer than ALL retention
                # answers from the deepest history, never from nothing)
                pts = level_pts
        inside = [p for p in pts if p[0] >= cutoff]
        if anchor:
            before = [p for p in pts if p[0] < cutoff]
            if before:
                inside.insert(0, before[-1])
        return inside

    def delta(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Increase of a cumulative counter over the trailing window
        (None until two samples exist). Negative deltas (a counter
        reset) clamp to 0 rather than crediting the window."""
        pts = self.window(name, window_s, now, anchor=True)
        if len(pts) < 2:
            return None
        return max(pts[-1][1] - pts[0][1], 0.0)

    def frac_beyond(
        self,
        name: str,
        threshold: float,
        window_s: float,
        now: Optional[float] = None,
        below: bool = False,
    ) -> Optional[float]:
        """Fraction of window samples strictly beyond ``threshold``
        (above by default; ``below=True`` flips). None with no data."""
        pts = self.window(name, window_s, now)
        if not pts:
            return None
        if below:
            bad = sum(1 for p in pts if p[1] < threshold)
        else:
            bad = sum(1 for p in pts if p[1] > threshold)
        return bad / len(pts)

    # -- bookkeeping --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "capacity": self._capacity,
                "resolutions": list(RESOLUTIONS),
                "overflowed": self._overflowed,
            }

    def latest(self, prefix: str = "") -> Dict[str, float]:
        """{name: newest value} for snapshot endpoints."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, s in self._series.items():
                if prefix and not name.startswith(prefix):
                    continue
                row = s.rings[0].last()
                if row is not None:
                    out[name] = row[1]
        return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._overflowed = 0


SERIES = SeriesStore()


# ---------------------------------------------------------------- the sampler


class TelemetryRuntime:
    """One daemon's telemetry loop: sample every counter/gauge,
    histogram percentile, and ledger level into ``SERIES`` on a
    cadence, then let the SLO engine evaluate over the fresh rings.
    Pure host bookkeeping — a sample never touches the device beyond
    the ledger's (rate-limited) memory poll, so arming telemetry costs
    zero jit-cache misses by construction."""

    def __init__(
        self,
        cadence_s: float = 1.0,
        slo_engine=None,
        series: Optional[SeriesStore] = None,
        clock=time.time,
    ):
        if cadence_s <= 0:
            from ..models.validation import InputError

            raise InputError(
                f"--obs-cadence must be > 0 seconds, got {cadence_s}"
            )
        self.cadence_s = float(cadence_s)
        self.slo_engine = slo_engine
        self.series = series if series is not None else SERIES
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.started_at = clock()
        # last-seen cumulative bucket counts per histogram site: the
        # sampled percentile series are INTERVAL percentiles (of the
        # observations since the previous sample), not process-lifetime
        # ones — a long-lived daemon's regression must move the series
        # now, not after it outweighs a day of history. Sampler-thread
        # confined (start()/stop() serialize around the thread).
        self._histo_counts: Dict[str, list] = {}

    # -- one sample ---------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> int:
        """Record one sample of everything; returns the number of
        series touched. Exposed for tests and the drain path (one
        final sample so the dump sees the end state)."""
        from ..utils.trace import COUNTERS

        now = self._clock() if now is None else now
        series = self.series
        n = 0
        snap = COUNTERS.snapshot()
        for key, value in snap["counts"].items():
            series.record(f"counter/{key}", now, value)
            n += 1
        for key, value in snap["gauges"].items():
            series.record(f"gauge/{key}", now, value)
            n += 1
        try:
            from .histo import HISTOS, percentile_from_counts
            from .ledger import LEDGER

            LEDGER.poll()  # refreshes the device_mem_* gauges (rate-limited)
            series.record("ledger/peak_bytes", now, LEDGER.peak_bytes)
            n += 1
            for site in HISTOS.names():
                h = HISTOS.peek(site)
                if h is None:
                    continue
                counts, total, _sum, _lo, _hi = h._snapshot()
                prev = self._histo_counts.get(site)
                self._histo_counts[site] = counts
                if prev is None:
                    delta = counts
                else:
                    delta = [c - p for c, p in zip(counts, prev)]
                if sum(delta) <= 0:
                    # no observations this interval: record nothing —
                    # an idle interval has no percentile, and a gap is
                    # honest where repeating the old value would let a
                    # stale regression (or recovery) linger in every
                    # window that follows
                    continue
                for q in (50, 95, 99):
                    series.record(
                        f"histo/{site}/p{q}_ms",
                        now,
                        percentile_from_counts(delta, q) * 1e3,
                    )
                series.record(f"histo/{site}/count", now, total)
                n += 4
        except Exception:  # noqa: BLE001 - a broken observatory must degrade sampling, never kill the daemon's loop
            COUNTERS.inc("telemetry_sample_errors_total")
        series.record(
            "recorder/spans_dropped", now, _spans.RECORDER.dropped
        )
        if self.slo_engine is not None:
            self.slo_engine.evaluate(now=now)
        return n + 1

    # -- lifecycle ----------------------------------------------------------

    def _run(self):
        while not self._stop.wait(timeout=self.cadence_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - the sampling loop must outlive any one bad sample
                from ..utils.trace import COUNTERS

                COUNTERS.inc("telemetry_sample_errors_total")

    def start(self) -> None:
        if self._thread is not None:
            return
        self.started_at = self._clock()
        self.sample_once()  # history exists from the first instant
        self._thread = threading.Thread(
            target=self._run, name="simon-telemetry", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        try:
            self.sample_once()  # the dump sees the drain-time state
        except Exception:  # noqa: BLE001,S110 - best-effort final sample on a dying process
            pass

    def uptime_s(self) -> float:
        return max(self._clock() - self.started_at, 0.0)


def arm_flight_recorder(max_spans: int = 100_000) -> None:
    """Continuous flight recorder for resident daemons: force RING
    mode (overwrite-oldest under a dropped counter) and enable the
    recorder if no CLI flag armed it already. A daemon's recorder is
    ALWAYS a ring — even when ``--trace-out`` armed it first (at the
    one-shot CLI's larger capacity): for a long-lived process the
    recent window is the useful artifact, a keep-the-startup-prefix
    trace is not, and the drain export carries the truncation marker
    either way. ``/debug/dump`` then always has recent spans, with
    bounded memory, without ``--trace-out``."""
    rec = _spans.RECORDER
    rec.ring = True
    if not rec.enabled:
        rec.max_spans = max_spans
        rec.enable()


# ---------------------------------------------------------- endpoint payloads


def series_endpoint(path: str) -> tuple:
    """GET /v1/obs/series handler body. Query params: ``name`` (exact,
    repeatable) or ``prefix``, ``sinceSeconds``, ``resolution`` (1 |
    8 | 64 raw steps per point), ``maxPoints``. Without name/prefix,
    answers the name catalog. Returns (status, payload dict)."""
    from ..models.validation import InputError

    q = parse_qs(urlparse(path).query)

    def one(key, cast, default):
        vals = q.get(key)
        if not vals:
            return default
        try:
            return cast(vals[-1])
        except (TypeError, ValueError):
            raise InputError(f"bad {key!r} value {vals[-1]!r}") from None

    try:
        names = q.get("name") or []
        prefix = one("prefix", str, "")
        since = one("sinceSeconds", float, None)
        resolution = one("resolution", int, 1)
        max_points = one("maxPoints", int, None)
        if not names and prefix:
            names = SERIES.names(prefix)
        if not names:
            return 200, {
                "names": SERIES.names(),
                "stats": SERIES.stats(),
            }
        out = {}
        for name in names[:256]:
            out[name] = SERIES.query(
                name,
                resolution=resolution,
                since_s=since,
                max_points=max_points,
            )
    except InputError as e:
        return 400, {"error": str(e)}
    return 200, {
        "now": time.time(),
        "resolution": resolution,
        "series": out,
    }


def snapshot_doc(
    slo_engine=None, runtime: Optional[TelemetryRuntime] = None, extra=None
) -> dict:
    """GET /v1/obs/snapshot payload: the daemon's live telemetry at one
    instant — newest value of every series, SLO states, recorder and
    store stats. `simon top` renders exactly this."""
    rec = _spans.RECORDER
    doc = {
        "now": time.time(),
        "latest": SERIES.latest(),
        "seriesStats": SERIES.stats(),
        "recorder": {
            "enabled": rec.enabled,
            "ring": rec.ring,
            "spans": rec.count,
            "dropped": rec.dropped,
        },
        "slo": slo_engine.as_dict() if slo_engine is not None else None,
    }
    if runtime is not None:
        doc["uptimeSeconds"] = round(runtime.uptime_s(), 3)
        doc["cadenceSeconds"] = runtime.cadence_s
    if extra:
        doc.update(extra)
    return doc


#: spans included inline in a debug dump; the full ring can be 100k+
#: spans and the dump must stay curl-able from a live daemon
DUMP_MAX_SPANS = 20_000


def debug_dump_doc(
    slo_engine=None,
    runtime: Optional[TelemetryRuntime] = None,
    label: str = "daemon",
) -> dict:
    """POST /debug/dump payload: spans + series + SLO + observatory
    state of a LIVE daemon, no restart. Shaped as a bench record
    (``metric``/``value``/``unit``/``obs``) so ``simon doctor`` can
    diff two dumps of the same daemon — launches, nvcc builds, peak
    device memory, per-site p95s all ride the standard obs block."""
    from ..utils.trace import COUNTERS

    rec = _spans.RECORDER
    all_spans = rec.snapshot()
    spans_out = all_spans[-DUMP_MAX_SPANS:]
    counters = COUNTERS.snapshot()
    obs = {
        "launches": counters["counts"].get("launches_total", 0),
        "device_launches": counters["counts"].get("device_launches_total", 0),
        "nvcc_builds": counters["counts"].get("nvcc_builds_total", 0),
        "spans_dropped": rec.dropped,
    }
    obs.update(_spans.observatory_block())
    doc = {
        "kind": "simon-debug-dump",
        "metric": f"{label}-debug-dump",
        "value": round(runtime.uptime_s(), 3) if runtime is not None else 0.0,
        "unit": "s",
        "counters": counters,
        "obs": obs,
        "slo": slo_engine.as_dict() if slo_engine is not None else None,
        "series": {
            name: SERIES.query(name, max_points=SERIES.stats()["capacity"])
            for name in SERIES.names()
        },
        "spans": {
            "total": len(all_spans),
            "included": len(spans_out),
            "dropped": rec.dropped,
            "top": _spans.top_spans(all_spans, 10),
            "events": [s.as_dict() for s in spans_out],
        },
    }
    return doc


# ------------------------------------------------------------- simon top

#: series `simon top` shows by default, existence-filtered against the
#: daemon's catalog (serve and twin names both listed; absent ones are
#: simply not rendered) — counters render as per-interval deltas
TOP_DEFAULT_SERIES = (
    "counter/serve_requests_total",
    "counter/serve_shed_total",
    "gauge/serve_queue_depth",
    "histo/serve/request/p95_ms",
    "histo/serve/evaluate/p95_ms",
    "counter/twin_deltas_applied_total",
    "gauge/twin_agreement_rate",
    "gauge/twin_mirror_lag_seconds",
    "histo/twin/query/p95_ms",
    "gauge/device_mem_bytes_in_use",
    "counter/nvcc_builds_total",
    "counter/spans_dropped_total",
)

#: fleet-router series `simon top --fleet` shows by default (same
#: existence-filtering as TOP_DEFAULT_SERIES — a router that has not
#: failed over yet simply has no failover gauges to draw)
FLEET_TOP_DEFAULT_SERIES = (
    "counter/fleet_requests_total",
    "counter/fleet_reroutes_total",
    "counter/fleet_shed_total",
    "counter/fleet_forward_failures_total",
    "counter/fleet_failovers_total",
    "counter/fleet_failover_ms_total",
    "gauge/fleet_slot_imbalance",
    "gauge/fleet_metrics_cache_age_seconds",
    "gauge/fleet_failover_seconds",
)

_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 40) -> str:
    """Unicode block sparkline of the trailing ``width`` values."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_CHARS[0] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK_CHARS[
            min(int((v - lo) / span * len(_SPARK_CHARS)), len(_SPARK_CHARS) - 1)
        ]
        for v in vals
    )


def _fmt_value(name: str, v: float) -> str:
    if "bytes" in name:
        for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
            if abs(v) < 1024 or unit == "TiB":
                return f"{v:.1f}{unit}"
            v /= 1024
    if abs(v) >= 1000:
        return f"{v:.0f}"
    return f"{v:.3g}"


def render_top_frame(
    snapshot: dict, series_doc: dict, url: str, width: int = 40
) -> str:
    """One `simon top` frame from a /v1/obs/snapshot payload and a
    /v1/obs/series payload — pure rendering, testable without a
    daemon. Counters draw their per-sample DELTAS (the rate shape);
    gauges and percentile series draw raw values."""
    lines = []
    health = snapshot.get("health", "?")
    uptime = snapshot.get("uptimeSeconds")
    head = (
        f"simon top — {snapshot.get('daemon', 'daemon')} @ {url} "
        f"[{health}]"
    )
    if uptime is not None:
        head += f"  up {uptime:.0f}s"
    rec = snapshot.get("recorder") or {}
    head += (
        f"  spans {rec.get('spans', 0)}"
        + (f" (dropped {rec['dropped']})" if rec.get("dropped") else "")
        + f"  series {((snapshot.get('seriesStats') or {}).get('series', 0))}"
    )
    lines.append(head)
    slo = snapshot.get("slo")
    if slo:
        alerting = set(slo.get("alerting") or ())
        lines.append("")
        lines.append(f"{'SLO':<28} {'burn fast':>10} {'burn slow':>10}  state")
        for st in slo.get("states") or ():
            name = (st.get("objective") or {}).get("name", "?")
            bf, bs = st.get("burnFast"), st.get("burnSlow")
            lines.append(
                f"{name:<28} "
                f"{('-' if bf is None else f'{bf:.2f}'):>10} "
                f"{('-' if bs is None else f'{bs:.2f}'):>10}  "
                + ("BURNING" if name in alerting else "ok")
            )
    series = series_doc.get("series") or {}
    if series:
        lines.append("")
        lines.append(f"{'signal':<40} {'last':>10}  history")
        for name in sorted(series):
            pts = series[name]
            if not pts:
                continue
            vals = [p[1] for p in pts]
            if name.startswith("counter/"):
                vals = [
                    max(b - a, 0.0) for a, b in zip(vals, vals[1:])
                ] or [0.0]
                last = vals[-1]
                label = name[len("counter/"):] + " Δ"
            else:
                last = vals[-1]
                label = name.split("/", 1)[1] if "/" in name else name
            lines.append(
                f"{label[:40]:<40} {_fmt_value(name, last):>10}  "
                f"{sparkline(vals, width)}"
            )
    return "\n".join(lines)


def fleet_slot_series(slot: str) -> List[str]:
    """The per-slot series names a fleet top frame reads (the caller
    URL-encodes them for the query string — slot labels ride inside
    series names)."""
    return [
        f"counter/fleet_replica_requests:{slot}",
        f"histo/fleet/forward/{slot}/p95_ms",
    ]


def render_fleet_top_frame(
    snapshot: dict, series_doc: dict, url: str, width: int = 40
) -> str:
    """One `simon top --fleet` frame from the ROUTER'S snapshot and
    series payloads: the fleet header + SLO burn table (shared with
    render_top_frame), then a per-slot pane — up/degraded/down, the
    slot's per-interval request rate, its forward p95 — and the
    fleet-wide signal sparklines. Tolerant BY CONSTRUCTION: a slot
    whose series are missing (TTL-cached scrape not refreshed yet, a
    replica that answered nothing this window) renders gaps ('-'),
    never a crash."""
    lines = [render_top_frame(snapshot, {"series": {}}, url, width=width)]
    series = series_doc.get("series") or {}
    replicas = snapshot.get("replicas") or {}
    if replicas:
        lines.append("")
        lines.append(
            f"{'slot':<12} {'state':<9} {'req Δ':>8} {'p95 ms':>8}  history"
        )
        for slot in sorted(replicas):
            reqs = series.get(f"counter/fleet_replica_requests:{slot}") or []
            p95 = series.get(f"histo/fleet/forward/{slot}/p95_ms") or []
            vals = [p[1] for p in reqs]
            deltas = [max(b - a, 0.0) for a, b in zip(vals, vals[1:])]
            rate = _fmt_value("", deltas[-1]) if deltas else "-"
            p95_last = _fmt_value("", p95[-1][1]) if p95 else "-"
            lines.append(
                f"{str(slot)[:12]:<12} {str(replicas[slot])[:9]:<9} "
                f"{rate:>8} {p95_last:>8}  "
                f"{sparkline(deltas, width) if deltas else ''}"
            )
    fleet_series = {
        name: pts
        for name, pts in series.items()
        if not name.startswith("counter/fleet_replica_requests:")
        and not name.startswith("histo/fleet/forward/")
    }
    if fleet_series:
        body = render_top_frame(
            {"daemon": "", "recorder": {}},
            {"series": fleet_series},
            url,
            width=width,
        )
        # drop the duplicate header line; keep the signal table
        lines.append("")
        lines.extend(body.splitlines()[1:])
    return "\n".join(lines)


def _confine_dump_path(path: str):
    """Resolve a server-side dump path, confined: RELATIVE to the
    daemon's working directory only (no absolute paths, no `..`
    escapes), and never overwriting an existing file. /debug/dump is
    reachable by anything that can reach the HTTP port — it must not
    be an arbitrary-file-write primitive (a client that wants the
    bytes elsewhere takes the inline dump and writes it itself).
    Returns the resolved path or raises InputError."""
    import os

    from ..models.validation import InputError

    p = str(path)
    if os.path.isabs(p):
        raise InputError(
            "dump path must be relative to the daemon's working "
            "directory (absolute paths refused); omit 'path' to get "
            "the dump inline"
        )
    root = os.path.realpath(os.getcwd())
    resolved = os.path.realpath(os.path.join(root, p))
    if resolved != root and not resolved.startswith(root + os.sep):
        raise InputError(
            f"dump path {path!r} escapes the daemon's working directory"
        )
    if os.path.exists(resolved):
        raise InputError(
            f"dump path {path!r} already exists (overwrite refused)"
        )
    return resolved


def handle_debug_dump(raw_body: bytes, **kwargs) -> tuple:
    """POST /debug/dump: optional JSON body ``{"path": "..."}`` writes
    the dump to a fresh file UNDER THE DAEMON'S WORKING DIRECTORY
    (relative paths only, no overwrite — see ``_confine_dump_path``)
    and answers a summary; without it the full dump is the response
    body. Returns (status, payload dict)."""
    path = None
    if raw_body and raw_body.strip():
        try:
            body = json.loads(raw_body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            return 400, {"error": f"body is not valid JSON: {e}"}
        if not isinstance(body, dict):
            return 400, {"error": "body must be a JSON object"}
        path = body.get("path")
    if path:
        try:
            resolved = _confine_dump_path(path)
        except ValueError as e:
            return 400, {"error": str(e)}
    doc = debug_dump_doc(**kwargs)
    if path:
        try:
            with open(resolved, "w", encoding="utf-8") as f:
                json.dump(doc, f)
        except OSError as e:
            return 400, {"error": f"cannot write dump to {path!r}: {e}"}
        return 200, {
            "written": resolved,
            "spans": doc["spans"]["total"],
            "series": len(doc["series"]),
            "sloAlerts": (doc["slo"] or {}).get("alerting", []),
        }
    return 200, doc
