"""Log-bucketed streaming latency histograms.

``utils.trace.Counters.percentile`` answers "p95 of the last 2048
samples" from a bounded reservoir — good enough for a serve dashboard,
but it forgets history (a burst of fast requests evicts the slow tail)
and a percentile read sorts the window under the lock. This module is
the long-memory complement: a fixed 64-bucket base-geometric histogram
per site, O(1) to record (one lock, one increment), never evicting,
with percentile reads that interpolate inside the landing bucket.

The precision contract is explicit: a percentile answer is exact to
within one bucket, i.e. a relative error bounded by ``RATIO - 1``
(~30% with the default 1e-5s..100s span). That is the right trade for
latency observability — "p99 is ~3ms vs ~300ms" is the question, not
the fourth significant digit — and it is pinned against a numpy
reference in tests/test_observatory.py.

Sites: every instrumented launch records its device time (CUDA events
on the card; the plain version's host time on the CPU) under
``launch/<site>`` (obs/profile.py). The histograms, with their buckets,
ride the observatory block of a trace artifact (obs/spans.py).

The port's copy of the JAX package's obs/histo.py.

Stdlib-only on purpose: obs/spans.py may reach this module from the
export path, and utils.trace loads obs.spans at import time.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

N_BUCKETS = 64
# bucket 0 is the underflow bin [0, LOW); bucket 63 the overflow bin
# [HIGH, inf); 62 geometric buckets span LOW..HIGH
LOW = 1e-5
HIGH = 100.0
RATIO = (HIGH / LOW) ** (1.0 / (N_BUCKETS - 2))
_LOG_RATIO = math.log(RATIO)

# bucket i (1 <= i <= 62) covers [LOW * RATIO**(i-1), LOW * RATIO**i)
_UPPER: List[float] = [LOW * RATIO ** i for i in range(N_BUCKETS - 1)] + [
    math.inf
]


def bucket_of(value: float) -> int:
    """The bucket index a (non-negative) observation lands in."""
    if value < LOW:
        return 0
    if value >= HIGH:
        return N_BUCKETS - 1
    # floor can land one off at exact bucket boundaries (float log);
    # nudge into the bucket whose bounds actually contain the value
    i = 1 + int(math.log(value / LOW) / _LOG_RATIO)
    i = min(max(i, 1), N_BUCKETS - 2)
    if value < _UPPER[i - 1]:
        i -= 1
    elif value >= _UPPER[i]:
        i += 1
    return min(max(i, 0), N_BUCKETS - 1)


class Histogram:
    """One thread-safe fixed-64-bucket streaming histogram. Recording
    is O(1) under the lock (an index computation, three adds); reads
    copy the counts under the lock and interpolate outside it."""

    __slots__ = ("_lock", "counts", "count", "sum", "min", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def record(self, value: float) -> None:
        v = float(value)
        if v < 0.0 or v != v:  # negative or NaN: clock skew, not data
            return
        idx = bucket_of(v)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def _snapshot(self):
        with self._lock:
            return (
                list(self.counts), self.count, self.sum, self.min, self.max
            )

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Nearest-rank walk over the cumulative bucket
        counts, linearly interpolated inside the landing bucket and
        clamped to the observed min/max (so p0/p100 are exact). 0.0
        when empty."""
        counts, total, _s, lo_seen, hi_seen = self._snapshot()
        if not total:
            return 0.0
        rank = max(1, min(total, int(math.ceil(q / 100.0 * total))))
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else _UPPER[i - 1]
                hi = _UPPER[i]
                if math.isinf(hi):
                    return hi_seen
                frac = (rank - cum - 0.5) / c
                v = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(max(v, lo_seen), hi_seen)
            cum += c
        return hi_seen

    def mean(self) -> float:
        _c, total, s, _lo, _hi = self._snapshot()
        return s / total if total else 0.0

    def as_dict(self) -> dict:
        counts, total, s, lo_seen, hi_seen = self._snapshot()
        return {
            "count": total,
            "sum_seconds": round(s, 6),
            "min_ms": round(lo_seen * 1e3, 3) if total else 0.0,
            "max_ms": round(hi_seen * 1e3, 3),
            "p50_ms": round(self.percentile(50) * 1e3, 3),
            "p95_ms": round(self.percentile(95) * 1e3, 3),
            "p99_ms": round(self.percentile(99) * 1e3, 3),
            "buckets": counts,
        }


class HistogramRegistry:
    """Process-wide name -> Histogram map. ``observe`` is the hot path:
    one dict lookup (creating on first sight) and one O(1) record."""

    def __init__(self):
        self._lock = threading.Lock()
        self._histos: Dict[str, Histogram] = {}

    def get(self, name: str) -> Histogram:
        with self._lock:
            h = self._histos.get(name)
            if h is None:
                h = self._histos[name] = Histogram()
            return h

    def observe(self, name: str, value: float) -> None:
        self.get(name).record(value)

    def peek(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._histos.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._histos)

    def reset(self) -> None:
        with self._lock:
            self._histos.clear()

    def summary(self, with_buckets: bool = False) -> dict:
        """{site: {count, p50_ms, p95_ms, p99_ms, ...}} for bench obs
        blocks and the serve drain dump. Buckets are included only when
        asked (observatory blocks in bench lines and trace artifacts,
        where tools/validate_trace.py checks bucket-sum arithmetic) —
        the serve drain dump stays readable without them."""
        out = {}
        for name in self.names():
            h = self.peek(name)
            if h is None or not h.count:
                continue
            d = h.as_dict()
            if not with_buckets:
                d.pop("buckets")
            out[name] = d
        return out


HISTOS = HistogramRegistry()


def percentile_from_counts(counts: List[int], q: float) -> float:
    """Percentile (seconds) from a raw 64-bucket count vector — the
    telemetry sampler's INTERVAL percentiles are computed from bucket
    DELTAS between two samples of a cumulative histogram, so a
    latency regression shows up at full strength in the next sample
    instead of being diluted into the process-lifetime distribution.
    Same landing-bucket interpolation as Histogram.percentile (without
    the observed min/max clamp — deltas carry no min/max); the
    overflow bucket answers its lower bound. 0.0 when empty."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = max(1, min(total, int(math.ceil(q / 100.0 * total))))
    cum = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= rank:
            lo = 0.0 if i == 0 else _UPPER[i - 1]
            hi = _UPPER[i]
            if math.isinf(hi):
                return _UPPER[i - 1]
            frac = (rank - cum - 0.5) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return _UPPER[-2]

# the subset of bucket boundaries exported as Prometheus `le` labels
# (cumulative, so any subset stays correct); every 4th + +Inf keeps
# the exposition ~17 lines per site instead of 65
_EXPO_BUCKETS = list(range(3, N_BUCKETS - 1, 4))


def prometheus_lines(prefix: str = "simon_latency_seconds") -> List[str]:
    """Prometheus histogram exposition for every registered site:
    `<prefix>_bucket{site="...",le="..."}` cumulative counts plus
    `_sum`/`_count`, and p50/p95/p99 gauges derived from the buckets."""
    lines: List[str] = []
    names = HISTOS.names()
    if not names:
        return lines
    lines.append(f"# HELP {prefix} Latency distribution per site.")
    lines.append(f"# TYPE {prefix} histogram")
    quantiles: Dict[int, List[str]] = {50: [], 95: [], 99: []}
    qname = prefix.replace("_seconds", "")
    for name in names:
        h = HISTOS.peek(name)
        if h is None:
            continue
        counts, total, s, _lo, _hi = h._snapshot()
        cum = 0
        emitted = 0
        for i, c in enumerate(counts):
            cum += c
            if i in _EXPO_BUCKETS and cum > emitted:
                lines.append(
                    f'{prefix}_bucket{{site="{name}",le="{_UPPER[i]:.6g}"}} {cum}'
                )
                emitted = cum
        lines.append(f'{prefix}_bucket{{site="{name}",le="+Inf"}} {total}')
        lines.append(f'{prefix}_sum{{site="{name}"}} {round(s, 6)}')
        lines.append(f'{prefix}_count{{site="{name}"}} {total}')
        for q in quantiles:
            quantiles[q].append(
                f'{qname}_p{q}_seconds{{site="{name}"}} '
                f"{round(h.percentile(q), 6)}"
            )
    for q, qlines in quantiles.items():
        if qlines:
            lines.append(
                f"# HELP {qname}_p{q}_seconds Per-site p{q} latency "
                "(bucket-interpolated)."
            )
            lines.append(f"# TYPE {qname}_p{q}_seconds gauge")
            lines.extend(qlines)
    return lines
