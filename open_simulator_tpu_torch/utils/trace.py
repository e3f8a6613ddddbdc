"""Tracing / profiling hooks.

The reference has none (SURVEY.md §5: no pprof, no OpenTelemetry; only
vendored scheduler metrics that are never scraped). Here per-phase
wall-clock is first-class: every scheduling run records named phases
(encode / scan / decode / replay / report ...) into a process-local
trace that can be printed as JSON, and an optional `torch.profiler`
capture can wrap any phase for device-level analysis
(`SIMON_PROFILE_DIR=...` -> a Chrome trace per phase).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# flight-recorder shim (obs/spans.py is stdlib-only, safe this early):
# when the span recorder is enabled, every phase() block also records a
# hierarchical span, so the flat phase timers become leaf spans of the
# trace tree for free — call sites unchanged
from ..obs.spans import RECORDER as _SPANS
from ..obs.spans import set_drop_hook as _set_span_drop_hook

_lock = threading.Lock()


@dataclass
class PhaseRecord:
    name: str
    seconds: float
    count: int = 1


@dataclass
class Trace:
    phases: Dict[str, PhaseRecord] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)
    notes: Dict[str, str] = field(default_factory=dict)
    # entries accumulated per append_note name (values may themselves
    # contain ';', so the cap tracks a real count, not a character scan)
    appended: Dict[str, int] = field(default_factory=dict)

    def add(self, name: str, seconds: float):
        with _lock:
            rec = self.phases.get(name)
            if rec is None:
                self.phases[name] = PhaseRecord(name, seconds)
                self.order.append(name)
            else:
                rec.seconds += seconds
                rec.count += 1

    def note(self, name: str, value: str):
        """Record a fact about the run (e.g. which engine path ran:
        `batch-kernel=cuda-fused-scan`) for `--trace` output."""
        with _lock:
            self.notes[name] = value
            self.appended.pop(name, None)

    def append_note(self, name: str, value: str):
        """Accumulate under one note name ('; '-joined). Degradation
        events (chunk-halving, serial fallback, swallowed template
        errors) append rather than overwrite so every occurrence keeps
        its reason in `--trace` output; capped at 50 entries so a
        pathological run cannot grow the trace without bound."""
        with _lock:
            n = self.appended.get(name, 0)
            self.appended[name] = n + 1
            if n == 0:
                self.notes[name] = str(value)
            elif n < 50:
                self.notes[name] = f"{self.notes[name]}; {value}"
            elif n == 50:
                self.notes[name] = self.notes[name] + "; ..."

    def reset(self):
        with _lock:
            self.phases.clear()
            self.order.clear()
            self.notes.clear()
            self.appended.clear()

    def as_dict(self) -> dict:
        # atomic snapshot: request threads sharing one process (simon
        # serve) mutate phases/notes concurrently with serialization,
        # so the whole read happens under the same lock the writers
        # hold — a trace JSON never shows a phase list and a note map
        # from two different instants
        with _lock:
            out = {
                "phases": [
                    {
                        "name": n,
                        "seconds": round(self.phases[n].seconds, 6),
                        "count": self.phases[n].count,
                    }
                    for n in self.order
                ],
                "total_seconds": round(
                    sum(p.seconds for p in self.phases.values()), 6
                ),
            }
            if self.notes:
                out["notes"] = dict(self.notes)
        return out

    def as_json(self) -> str:
        return json.dumps(self.as_dict())

    def phase_seconds(self, name: str) -> float:
        """Accumulated wall-clock of one named phase (0.0 when it never
        ran) — the bench's sort/encode/scan/replay breakdown reads the
        tiered engine's phases (`host/expand`, `priority/sort`,
        `engine/encode`, `engine/scan`, `engine/replay`) through this
        instead of re-deriving them from as_dict()."""
        with _lock:
            rec = self.phases.get(name)
            return rec.seconds if rec is not None else 0.0


# process-wide trace; callers that need isolation use Trace() directly
GLOBAL = Trace()


@contextmanager
def phase(name: str, trace: Optional[Trace] = None):
    """Record wall-clock of the enclosed block under `name`. When the
    flight recorder is on (--trace-out), the block is also recorded as
    a span nested under the caller's current span — phases called
    inside phases nest automatically via the contextvar parent."""
    span_cm = _SPANS.span(name, kind="phase") if _SPANS.enabled else None
    if span_cm is not None:
        span_cm.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (trace or GLOBAL).add(name, time.perf_counter() - t0)
        if span_cm is not None:
            span_cm.__exit__(None, None, None)


class Counters:
    """Thread-safe process-wide operational counters (simon serve's
    `/metrics` endpoint reads these; the coalescer and the HTTP
    handler threads write them concurrently).

    Three kinds, all guarded by one lock:

    - counters (`inc`): monotonically increasing totals (requests,
      sheds, device dispatches)
    - gauges (`gauge`): last-written values (queue depth, batch fill)
    - observations (`observe`): bounded reservoirs of recent samples
      (request latency, batch fill) from which `percentile` and `mean`
      derive summary stats, plus a timestamp ring for `rate` (QPS over
      a sliding window)

    `snapshot()` returns everything at one instant — the same
    atomic-read contract as Trace.as_dict.
    """

    _WINDOW = 2048

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._counts: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._obs: Dict[str, List[float]] = {}
        # event counts in 1-second buckets [(bucket_epoch_s, count)]:
        # bounded by TIME (pruned past _RATE_KEEP_S), not entry count,
        # so `rate` never saturates at high event rates the way a
        # fixed-size timestamp ring would
        self._marks: Dict[str, List[List[float]]] = {}
        self._first_mark: Dict[str, float] = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            buf = self._obs.setdefault(name, [])
            buf.append(float(value))
            if len(buf) > self._WINDOW:
                del buf[: len(buf) - self._WINDOW]

    _RATE_KEEP_S = 600.0

    def mark(self, name: str) -> None:
        """Record one event for `rate` (1-second bucket counts)."""
        # clock read outside the lock: `_clock` is set once in __init__
        # and never mutated, so reading it unlocked is race-free — and
        # keeping it out of the locked region means every access to it
        # is unlocked, which is what lets CONC001 see it as unguarded
        now = self._clock()
        with self._lock:
            self._first_mark.setdefault(name, now)
            buf = self._marks.setdefault(name, [])
            bucket = float(int(now))
            if buf and buf[-1][0] == bucket:
                buf[-1][1] += 1
            else:
                buf.append([bucket, 1])
                while buf and now - buf[0][0] > self._RATE_KEEP_S:
                    buf.pop(0)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def mean(self, name: str) -> float:
        with self._lock:
            buf = self._obs.get(name)
            return (sum(buf) / len(buf)) if buf else 0.0

    def percentile(self, name: str, q: float) -> float:
        """q in [0, 100], nearest-rank on the recent-sample window."""
        with self._lock:
            buf = sorted(self._obs.get(name) or ())
        if not buf:
            return 0.0
        k = min(len(buf) - 1, max(0, int(round(q / 100.0 * (len(buf) - 1)))))
        return buf[k]

    def rate(self, name: str, window_s: float = 60.0) -> float:
        """Events per second over the trailing `window_s`. The
        denominator is the WINDOW, not the burst span — an idle hour
        followed by 10 events in 2s is a trailing rate of 10/60, not
        10/2. Only when the very first event is younger than the
        window does the denominator shrink to the observed age (>= 1s),
        so a fresh daemon reports its true rate instead of a diluted
        one.

        Window membership is decided in WHOLE buckets: a 1-second
        bucket `b` is in the window iff `b > floor(now) - window_s`.
        Events are floored into buckets at mark() time, so comparing
        the fractional `now` against bucket starts (the old
        `now - t <= window_s` test) made inclusion depend on the
        read-time clock phase: an event marked at t=100.2 (bucket 100)
        was counted at now=160.0 but dropped at now=160.5 — same age,
        different verdict — and a reader sampling twice around a
        boundary could see the event twice in one window and never in
        the next. Whole-bucket membership gives every (event, read)
        pair one deterministic verdict regardless of sub-second
        alignment (pinned by the fake-clock tests in
        tests/test_trace.py)."""
        now = self._clock()
        cutoff = math.floor(now) - window_s
        with self._lock:
            buf = self._marks.get(name) or []
            recent = sum(c for t, c in buf if t > cutoff)
            first_ever = self._first_mark.get(name)
        if not recent:
            return 0.0
        denom = window_s
        if first_ever is not None and now - first_ever < window_s:
            denom = max(now - first_ever, 1.0)
        return recent / denom

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._gauges.clear()
            self._obs.clear()
            self._marks.clear()
            self._first_mark.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counts": dict(self._counts),
                "gauges": dict(self._gauges),
                "observations": {k: len(v) for k, v in self._obs.items()},
            }


# process-wide operational counters (simon serve /metrics); distinct
# from GLOBAL (phase wall-clock) — counters survive GLOBAL.reset()
COUNTERS = Counters()


def _count_dropped_spans(n: int = 1) -> None:
    """Span-recorder overflow hook: a truncated trace must be
    detectable from /metrics (simon_spans_dropped_total) and from the
    run's trace notes, not just from eyeballing span counts."""
    COUNTERS.inc("spans_dropped_total", n)
    GLOBAL.note("spans_dropped", str(COUNTERS.get("spans_dropped_total")))


_set_span_drop_hook(_count_dropped_spans)


class ProfileCaptureError(RuntimeError):
    """A `--profile-dir` capture on the card that recorded no CUDA
    activity: the profiler's device tracing (CUPTI) is refused there,
    and a capture of host activity alone would be passed off as the
    device's."""


_CAPTURES: Dict[str, int] = {}


@contextmanager
def profiled(name: str, trace: Optional[Trace] = None):
    """phase() + a `torch.profiler` capture when SIMON_PROFILE_DIR is set.

    The capture lands in $SIMON_PROFILE_DIR/<name>-<n>.json (the n-th
    run of the phase) as a Chrome trace (viewable in Perfetto or
    chrome://tracing). When the phase launched work on the card
    (obs/profile.py `device_launches_total` moved), the capture records
    CUDA activity too and must hold it: a capture that recorded no
    device event raises ProfileCaptureError, with what the profiler
    recorded, rather than keep a host-only trace."""
    profile_dir = os.environ.get("SIMON_PROFILE_DIR")
    if not profile_dir:
        with phase(name, trace):
            yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with _lock:
        n = _CAPTURES[name] = _CAPTURES.get(name, 0) + 1
    target = os.path.join(profile_dir, f"{name.replace('/', '_')}-{n}.json")
    launches = COUNTERS.get("device_launches_total")
    with phase(name, trace):
        with profile(activities=activities) as prof:
            yield
    if COUNTERS.get("device_launches_total") > launches:
        kinds = {str(e.device_type) for e in prof.events()}
        if not any("CUDA" in k for k in kinds):
            raise ProfileCaptureError(
                f"--profile-dir: torch.profiler recorded no CUDA activity in phase "
                f"{name!r} although it launched work on the card (event device "
                f"types: {sorted(kinds)}); the profiler's device tracing is not "
                "available on this machine")
    prof.export_chrome_trace(target)
