"""SLO engine: declarative objectives + multi-window burn-rate alerts.

Thresholding an instantaneous gauge pages on noise; averaging over a
day pages a week late. The production answer (SRE-workbook style) is
BURN RATE over two windows: how fast is the error budget being spent,
measured over a FAST window (reacts in minutes) AND a SLOW window
(filters blips). An alert fires only when both windows burn past the
threshold, and clears as soon as the fast window recovers — fast to
page, fast to stand down, hard to flap.

Objectives are declarative records (JSON or YAML, ``--slo-config``),
evaluated over the resident series rings (obs/telemetry.py) on the
sampling cadence. Four kinds, all reduced to one vocabulary — a
``bad_ratio(window)`` against an error budget ``eb``, with
``burn = bad_ratio / eb``:

- ``availability``: Δbad / Δtotal of two cumulative counters over the
  window; ``eb = 1 - target`` (target e.g. 0.999).
- ``latency``: fraction of window samples whose tracked percentile
  series (``histo/<site>/p95_ms``) exceeded ``threshold_ms``;
  ``eb = budget`` (allowed violating fraction).
- ``gauge_min``: fraction of window samples of a gauge below ``min``
  (agreement rate, mirror freshness); ``eb = budget``.
- ``counter_budget``: Δcounter over the fast window against an
  absolute ``maxPerWindow`` allowance (build budget: 0 means ANY
  growth burns).

Three FLEET kinds judge the router as one service (the router runs
its own engine over the aggregated ``fleet_*`` counters):

- ``fleet_availability``: availability over the router's counters,
  defaulting to ``fleet_requests_total`` / ``fleet_shed_total`` — a
  rerouted-but-answered request is GOOD (reroutes are the fleet doing
  its job), only an exhaustion shed spends budget.
- ``fleet_imbalance``: fraction of window samples of the
  ``fleet_slot_imbalance`` gauge ABOVE ``max`` (hottest slot's load
  over the fleet mean, minus one); ``eb = budget``.
- ``fleet_failover``: seconds of audited failover time
  (``fleet_failover_ms_total``, fleet/audit.py) per fast window
  against a ``maxSecondsPerWindow`` allowance.

Alert states export as ``simon_slo_*`` metrics on ``/metrics``, surface
in ``/healthz`` ``reasons[]``, and ride ``/v1/obs/snapshot`` and the
``/debug/dump`` body. The inject seams drive them: an armed fault
storm must flip a declared SLO to burning, and the alert must clear
after the faults stop (docs/OBSERVABILITY.md).

The port's copy of the JAX package's obs/slo.py. The fleet kinds parse
and evaluate here too, over the fleet router's series (fleet/router.py).
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..models.validation import InputError
from ..utils.trace import COUNTERS
from . import telemetry

KINDS = (
    "availability",
    "latency",
    "gauge_min",
    "counter_budget",
    "fleet_availability",
    "fleet_imbalance",
    "fleet_failover",
)

DEFAULT_FAST_WINDOW_S = 300.0
DEFAULT_SLOW_WINDOW_S = 3600.0
DEFAULT_BURN_THRESHOLD = 1.0
DEFAULT_BUDGET = 0.05

#: burn value exported when the budget is zero and violations exist —
#: "infinitely burning" must stay JSON- and Prometheus-representable
BURN_SATURATED = 1e9


@dataclass
class Objective:
    """One declared SLO. Field relevance depends on ``kind`` (the
    loader validates the combination)."""

    name: str
    kind: str
    target: float = 0.0  # availability: good fraction (e.g. 0.999)
    total: str = ""  # availability: cumulative counter of all events
    bad: str = ""  # availability: cumulative counter of bad events
    site: str = ""  # latency: histogram site (serve/request, ...)
    percentile: int = 95  # latency: which tracked percentile series
    threshold_ms: float = 0.0  # latency: bad past this
    gauge: str = ""  # gauge_min: gauge name (twin_agreement_rate, ...)
    min_value: float = 0.0  # gauge_min: bad below this
    counter: str = ""  # counter_budget/fleet_failover: counter name
    max_per_window: float = 0.0  # counter_budget: fast-window allowance
    max_value: float = 0.0  # fleet_imbalance: bad above this
    budget: float = DEFAULT_BUDGET  # latency/gauge_min error budget
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S
    burn_threshold: float = DEFAULT_BURN_THRESHOLD

    def series_name(self) -> str:
        """The ring series this objective's bad-ratio reads."""
        if self.kind in ("availability", "fleet_availability"):
            return f"counter/{self.bad}"
        if self.kind == "latency":
            return f"histo/{self.site}/p{self.percentile}_ms"
        if self.kind in ("gauge_min", "fleet_imbalance"):
            return f"gauge/{self.gauge}"
        return f"counter/{self.counter}"

    def error_budget(self) -> float:
        if self.kind in ("availability", "fleet_availability"):
            return max(1.0 - self.target, 1e-9)
        return max(self.budget, 1e-9)

    # -- evaluation ---------------------------------------------------------

    def burn(
        self, series: "telemetry.SeriesStore", window_s: float, now: float
    ) -> Optional[float]:
        """Burn rate over one window; None until enough data exists
        (an objective with no history neither fires nor clears)."""
        if self.kind in ("availability", "fleet_availability"):
            total = series.delta(f"counter/{self.total}", window_s, now)
            bad = series.delta(f"counter/{self.bad}", window_s, now)
            if total is None:
                return None
            if bad is None:
                bad = 0.0
            if total <= 0:
                # no traffic: an empty window spends no budget
                return 0.0 if bad <= 0 else BURN_SATURATED
            return min((bad / total) / self.error_budget(), BURN_SATURATED)
        if self.kind == "fleet_imbalance":
            frac = series.frac_beyond(
                self.series_name(), self.max_value, window_s, now
            )
            if frac is None:
                return None
            return min(frac / self.error_budget(), BURN_SATURATED)
        if self.kind == "fleet_failover":
            # the audited-failover counter is milliseconds (Counters
            # increments are integral); the allowance is seconds
            delta_ms = series.delta(self.series_name(), window_s, now)
            if delta_ms is None:
                return None
            spent_s = delta_ms / 1e3
            if self.max_per_window <= 0:
                return 0.0 if spent_s <= 0 else BURN_SATURATED
            return min(spent_s / self.max_per_window, BURN_SATURATED)
        if self.kind == "latency":
            frac = series.frac_beyond(
                self.series_name(), self.threshold_ms, window_s, now
            )
            if frac is None:
                return None
            return min(frac / self.error_budget(), BURN_SATURATED)
        if self.kind == "gauge_min":
            frac = series.frac_beyond(
                self.series_name(), self.min_value, window_s, now, below=True
            )
            if frac is None:
                return None
            return min(frac / self.error_budget(), BURN_SATURATED)
        # counter_budget: absolute allowance per window
        delta = series.delta(self.series_name(), window_s, now)
        if delta is None:
            return None
        if self.max_per_window <= 0:
            return 0.0 if delta <= 0 else BURN_SATURATED
        return min(delta / self.max_per_window, BURN_SATURATED)

    def as_dict(self) -> dict:
        out = {
            "name": self.name,
            "kind": self.kind,
            "series": self.series_name(),
            "fastWindowSeconds": self.fast_window_s,
            "slowWindowSeconds": self.slow_window_s,
            "burnThreshold": self.burn_threshold,
        }
        if self.kind in ("availability", "fleet_availability"):
            out.update(target=self.target, total=self.total, bad=self.bad)
        elif self.kind == "latency":
            out.update(
                site=self.site,
                percentile=self.percentile,
                thresholdMs=self.threshold_ms,
                budget=self.budget,
            )
        elif self.kind == "gauge_min":
            out.update(
                gauge=self.gauge, min=self.min_value, budget=self.budget
            )
        elif self.kind == "fleet_imbalance":
            out.update(
                gauge=self.gauge, max=self.max_value, budget=self.budget
            )
        elif self.kind == "fleet_failover":
            out.update(
                counter=self.counter,
                maxSecondsPerWindow=self.max_per_window,
            )
        else:
            out.update(
                counter=self.counter, maxPerWindow=self.max_per_window
            )
        return out


@dataclass
class AlertState:
    """One objective's live verdict after the latest evaluation."""

    objective: Objective
    burn_fast: Optional[float] = None
    burn_slow: Optional[float] = None
    alerting: bool = False
    since: Optional[float] = None
    fired_total: int = 0
    cleared_total: int = 0
    last_eval: float = field(default_factory=time.time)

    def as_dict(self) -> dict:
        return {
            "objective": self.objective.as_dict(),
            "burnFast": self.burn_fast,
            "burnSlow": self.burn_slow,
            "alerting": self.alerting,
            "since": self.since,
            "firedTotal": self.fired_total,
            "clearedTotal": self.cleared_total,
        }


# ---------------------------------------------------------------- the engine


class SLOEngine:
    """Evaluates every declared objective over the series rings; holds
    the alert state machine (fire: fast AND slow burning; clear: fast
    recovered). Evaluation rides the telemetry sampler's cadence;
    ``/metrics`` and ``/healthz`` read the held state without
    re-evaluating."""

    def __init__(self, objectives: List[Objective], series=None, clock=time.time):
        self._lock = threading.Lock()
        self._clock = clock
        self.series = series if series is not None else telemetry.SERIES
        self._states: Dict[str, AlertState] = {
            o.name: AlertState(objective=o) for o in objectives
        }

    @property
    def objectives(self) -> List[Objective]:
        with self._lock:
            return [s.objective for s in self._states.values()]

    def evaluate(self, now: Optional[float] = None) -> List[AlertState]:
        """One evaluation pass over every objective; returns the
        resulting states (copies are cheap; callers mutate nothing)."""
        now = self._clock() if now is None else now
        with self._lock:
            states = list(self._states.values())
        for st in states:
            o = st.objective
            bf = o.burn(self.series, o.fast_window_s, now)
            bs = o.burn(self.series, o.slow_window_s, now)
            with self._lock:
                st.burn_fast, st.burn_slow, st.last_eval = bf, bs, now
                if (
                    not st.alerting
                    and bf is not None
                    and bs is not None
                    and bf >= o.burn_threshold
                    and bs >= o.burn_threshold
                ):
                    st.alerting = True
                    st.since = now
                    st.fired_total += 1
                    COUNTERS.inc("slo_alerts_fired_total")
                elif st.alerting and (bf is None or bf < o.burn_threshold):
                    st.alerting = False
                    st.since = None
                    st.cleared_total += 1
                    COUNTERS.inc("slo_alerts_cleared_total")
        return states

    # -- reads --------------------------------------------------------------

    def states(self) -> List[AlertState]:
        with self._lock:
            return list(self._states.values())

    def alerting(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._states.items() if s.alerting]

    def reasons(self) -> List[str]:
        """/healthz ``reasons[]`` lines for burning objectives."""
        out = []
        with self._lock:
            for name, st in self._states.items():
                if not st.alerting:
                    continue
                bf = -1.0 if st.burn_fast is None else st.burn_fast
                bs = -1.0 if st.burn_slow is None else st.burn_slow
                out.append(
                    f"slo burning: {name} (burn fast {bf:.2f} / "
                    f"slow {bs:.2f} >= {st.objective.burn_threshold:g})"
                )
        return out

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "objectives": len(self._states),
                "alerting": [
                    n for n, s in self._states.items() if s.alerting
                ],
                "states": [s.as_dict() for s in self._states.values()],
            }

    def prometheus_lines(self) -> List[str]:
        """The ``simon_slo_*`` exposition block (one family each for
        target-ish info, burn rates, and the alert bit)."""
        with self._lock:
            states = [
                (name, st, st.objective) for name, st in self._states.items()
            ]
        if not states:
            return []
        lines = [
            "# HELP simon_slo_burn_rate Error-budget burn rate per "
            "objective and window (>= threshold in BOTH windows fires).",
            "# TYPE simon_slo_burn_rate gauge",
        ]
        for name, st, _o in states:
            for window, burn in (("fast", st.burn_fast), ("slow", st.burn_slow)):
                if burn is None:
                    continue
                lines.append(
                    f'simon_slo_burn_rate{{slo="{name}",window="{window}"}} '
                    f"{round(burn, 6)}"
                )
        lines.append(
            "# HELP simon_slo_burn_threshold Burn rate at/past which an "
            "objective fires."
        )
        lines.append("# TYPE simon_slo_burn_threshold gauge")
        for name, _st, o in states:
            lines.append(
                f'simon_slo_burn_threshold{{slo="{name}"}} {o.burn_threshold}'
            )
        lines.append(
            "# HELP simon_slo_alert 1 while the objective's multi-window "
            "burn alert is firing."
        )
        lines.append("# TYPE simon_slo_alert gauge")
        for name, st, _o in states:
            lines.append(f'simon_slo_alert{{slo="{name}"}} {int(st.alerting)}')
        snap = COUNTERS.snapshot()["counts"]
        for key, help_text in (
            ("slo_alerts_fired_total", "SLO alerts fired (state transitions)."),
            ("slo_alerts_cleared_total", "SLO alerts cleared."),
        ):
            lines.append(f"# HELP simon_{key} {help_text}")
            lines.append(f"# TYPE simon_{key} counter")
            lines.append(f"simon_{key} {snap.get(key, 0)}")
        return lines


# ---------------------------------------------------------------- the loader

_NAME_OK = re.compile(r"^[A-Za-z0-9_.:-]{1,64}$")


def parse_objective(rec: dict) -> Objective:
    """One config record as a validated Objective; raises InputError
    with the offending field on anything malformed."""
    if not isinstance(rec, dict):
        raise InputError("slo record is not an object")
    name = str(rec.get("name") or "")
    if not _NAME_OK.match(name):
        raise InputError(
            f"slo name {name!r} must be 1-64 chars of [A-Za-z0-9_.:-] "
            "(it becomes a metric label)"
        )
    kind = str(rec.get("kind") or "")
    if kind not in KINDS:
        raise InputError(
            f"slo {name!r}: unknown kind {kind!r} (one of {', '.join(KINDS)})"
        )

    def num(key, default=None, lo=None, hi=None):
        v = rec.get(key, default)
        if v is None:
            return None
        try:
            v = float(v)
        except (TypeError, ValueError):
            raise InputError(f"slo {name!r}: {key} must be a number") from None
        if lo is not None and v < lo:
            raise InputError(f"slo {name!r}: {key} must be >= {lo}")
        if hi is not None and v > hi:
            raise InputError(f"slo {name!r}: {key} must be <= {hi}")
        return v

    o = Objective(name=name, kind=kind)
    o.fast_window_s = num("fastWindowSeconds", DEFAULT_FAST_WINDOW_S, lo=1.0)
    o.slow_window_s = num("slowWindowSeconds", DEFAULT_SLOW_WINDOW_S, lo=1.0)
    if o.slow_window_s < o.fast_window_s:
        raise InputError(
            f"slo {name!r}: slowWindowSeconds ({o.slow_window_s:g}) must "
            f"be >= fastWindowSeconds ({o.fast_window_s:g})"
        )
    o.burn_threshold = num("burnThreshold", DEFAULT_BURN_THRESHOLD, lo=0.0)
    if kind in ("availability", "fleet_availability"):
        # fleet_availability defaults to the router's own counters: a
        # rerouted-but-answered request never spends budget, only an
        # exhaustion shed does
        dflt_total = "fleet_requests_total" if kind.startswith("fleet") else ""
        dflt_bad = "fleet_shed_total" if kind.startswith("fleet") else ""
        o.total = str(rec.get("total") or dflt_total)
        o.bad = str(rec.get("bad") or dflt_bad)
        if not o.total or not o.bad:
            raise InputError(
                f"slo {name!r}: availability needs 'total' and 'bad' "
                "counter names"
            )
        o.target = num("target", None, lo=0.0, hi=1.0)
        if o.target is None or o.target >= 1.0:
            raise InputError(
                f"slo {name!r}: {kind} needs target in [0, 1)"
            )
    elif kind == "fleet_imbalance":
        o.gauge = str(rec.get("gauge") or "fleet_slot_imbalance")
        v = num("max", None, lo=0.0)
        if v is None:
            raise InputError(f"slo {name!r}: fleet_imbalance needs 'max'")
        o.max_value = v
        o.budget = num("budget", DEFAULT_BUDGET, lo=1e-9, hi=1.0)
    elif kind == "fleet_failover":
        o.counter = str(rec.get("counter") or "fleet_failover_ms_total")
        v = num("maxSecondsPerWindow", None, lo=0.0)
        if v is None:
            raise InputError(
                f"slo {name!r}: fleet_failover needs 'maxSecondsPerWindow'"
            )
        o.max_per_window = v
    elif kind == "latency":
        o.site = str(rec.get("site") or "")
        if not o.site:
            raise InputError(f"slo {name!r}: latency needs a 'site'")
        pct = num("percentile", 95.0)
        if int(pct) not in (50, 95, 99):
            raise InputError(
                f"slo {name!r}: percentile must be 50, 95, or 99 (the "
                "tracked percentile series)"
            )
        o.percentile = int(pct)
        o.threshold_ms = num("thresholdMs", None, lo=0.0)
        if o.threshold_ms is None:
            raise InputError(f"slo {name!r}: latency needs 'thresholdMs'")
        o.budget = num("budget", DEFAULT_BUDGET, lo=1e-9, hi=1.0)
    elif kind == "gauge_min":
        o.gauge = str(rec.get("gauge") or "")
        if not o.gauge:
            raise InputError(f"slo {name!r}: gauge_min needs a 'gauge'")
        v = num("min", None)
        if v is None:
            raise InputError(f"slo {name!r}: gauge_min needs 'min'")
        o.min_value = v
        o.budget = num("budget", DEFAULT_BUDGET, lo=1e-9, hi=1.0)
    else:  # counter_budget
        o.counter = str(rec.get("counter") or "")
        if not o.counter:
            raise InputError(f"slo {name!r}: counter_budget needs 'counter'")
        o.max_per_window = num("maxPerWindow", 0.0, lo=0.0)
    return o


def parse_objectives(doc) -> List[Objective]:
    if isinstance(doc, dict):
        doc = doc.get("slos")
    if not isinstance(doc, list) or not doc:
        raise InputError(
            'slo config must be a non-empty list (or {"slos": [...]})'
        )
    objectives = [parse_objective(rec) for rec in doc]
    seen = set()
    for o in objectives:
        if o.name in seen:
            raise InputError(f"duplicate slo name {o.name!r}")
        seen.add(o.name)
    return objectives


def load_slo_config(path: str) -> List[Objective]:
    """Objectives from a JSON or YAML file (--slo-config). The
    documented grammar lives in docs/OBSERVABILITY.md."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise InputError(f"cannot read slo config {path!r}: {e}") from e
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml

        try:
            doc = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise InputError(
                f"slo config {path!r} is neither JSON nor YAML: {e}"
            ) from e
    return parse_objectives(doc)
