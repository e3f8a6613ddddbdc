"""Perf-regression doctor: diff two bench records, gate on thresholds.

The BENCH_r*.json trajectory was a pile of JSON files a human eyeballed
("is 202 dispatches still 202?"). This module makes it an enforced
contract: load a baseline bench record and a candidate (fresh) one,
diff the headline value plus every observatory dimension — device
dispatches, XLA recompiles, peak HBM from the memory ledger, per-site
latency p95s from the histograms — against per-dimension thresholds,
and report regressions machine-readably. ``simon doctor OLD NEW``
(cli.py) and ``bench.py --against OLD`` both ride this; CI runs the
doctor over the checked-in trajectory so a regression fails the build
instead of landing in the next BENCH file.

Threshold semantics (docs/OBSERVABILITY.md):

- counts (dispatches, recompiles): ABSOLUTE slack, default 0 — these
  are semantic on a fixed scenario, so "one more dispatch" is a real
  behavior change, not noise;
- times/rates/bytes (value, peak HBM, p95): FRACTIONAL slack, default
  0.5 (±50%) — wall-clock on shared CPU runners is noisy, so only a
  step change trips. Direction comes from the unit: seconds-like
  values regress UP, rate-like values (pods/s, req/s, steps/s)
  regress DOWN.

A dimension missing from EITHER record is skipped (older BENCH files
predate the observatory blocks) — the doctor compares what both sides
measured, never invents a zero.

The port's copy of the JAX package's obs/doctor.py: it reads that
package's bench-record format (the checked-in BENCH_r*.json). A record
format of the port's own comes with the port's benchmark.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..models.validation import InputError

# units whose headline value is better when LARGER; everything else
# (s, mismatches, bytes) regresses upward
_RATE_UNITS = {"pods/s", "req/s", "steps/s", "qps", "rows/s", "deltas/s"}


@dataclass
class Thresholds:
    value_frac: float = 0.5
    dispatch_abs: int = 0
    recompile_abs: int = 0
    hbm_frac: float = 0.5
    p95_frac: float = 0.5
    # incremental families (r15): the suffix fraction regresses UP (a
    # bigger fraction = re-scanning rows the journal should have
    # reused); the store hit rate regresses DOWN (cold starts paying
    # compiles a warm store should have served)
    suffix_frac: float = 0.5
    store_frac: float = 0.5
    store_reject_abs: int = 0
    # fleet families (r16): qps_scaling regresses DOWN (lost
    # horizontal scaling), failover_seconds regresses UP (slower
    # recovery after a replica kill)
    fleet_frac: float = 0.5
    # checkpoint family (r17): restore_seconds on the AGED failover
    # cells regresses UP — recovery time growing with absorbed-delta
    # age means the checkpoint + compacted-suffix bound broke
    ckpt_frac: float = 0.5

    @classmethod
    def from_args(cls, args) -> "Thresholds":
        return cls(
            value_frac=getattr(args, "time_tolerance", 0.5),
            dispatch_abs=getattr(args, "dispatch_tolerance", 0),
            recompile_abs=getattr(args, "recompile_tolerance", 0),
            hbm_frac=getattr(args, "hbm_tolerance", 0.5),
            p95_frac=getattr(args, "p95_tolerance", 0.5),
            suffix_frac=getattr(args, "suffix_tolerance", 0.5),
            store_frac=getattr(args, "store_tolerance", 0.5),
            store_reject_abs=getattr(args, "store_reject_tolerance", 0),
            fleet_frac=getattr(args, "fleet_tolerance", 0.5),
            ckpt_frac=getattr(args, "ckpt_tolerance", 0.5),
        )


@dataclass
class DiffRow:
    dimension: str
    baseline: float
    candidate: float
    threshold: str
    regressed: bool
    note: str = ""

    def as_dict(self) -> dict:
        return {
            "dimension": self.dimension,
            "baseline": self.baseline,
            "candidate": self.candidate,
            "threshold": self.threshold,
            "regressed": self.regressed,
            "note": self.note,
        }


@dataclass
class DoctorReport:
    rows: List[DiffRow] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)

    @property
    def regressions(self) -> List[DiffRow]:
        return [r for r in self.rows if r.regressed]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "regressions": len(self.regressions),
            "rows": [r.as_dict() for r in self.rows],
            "skipped": self.skipped,
        }


def load_bench_record(path: str) -> dict:
    """Load a bench record from any of its on-disk shapes: the raw
    one-line JSON bench.py prints, a file of several such lines (last
    wins — the bench prints progress lines first), or the checked-in
    BENCH_r*.json wrapper whose ``tail`` field holds the line. Raises
    InputError with the offending path on anything else."""
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    if not text:
        raise InputError(f"{path}: empty file")
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and "tail" in doc and "metric" not in doc:
        text = str(doc["tail"]).strip()
        doc = None
    if doc is None:
        # one record per line; take the last parseable line with a
        # "metric" key (bench progress output precedes the record)
        best = None
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                cand = json.loads(line)
            except ValueError:
                continue
            if isinstance(cand, dict) and "metric" in cand:
                best = cand
        if best is None:
            raise InputError(
                f"{path}: no bench record found (expected a JSON object "
                'with a "metric" key, a JSONL of them, or a BENCH_r*.json '
                "wrapper)"
            )
        doc = best
    if not isinstance(doc, dict) or "metric" not in doc:
        raise InputError(f"{path}: not a bench record (no 'metric' key)")
    return doc


def _num(d: dict, *keys) -> Optional[float]:
    cur = d
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return None
        cur = cur[k]
    return float(cur) if isinstance(cur, (int, float)) else None


def diff_records(
    base: dict, cand: dict, thresholds: Optional[Thresholds] = None
) -> DoctorReport:
    """Diff two bench records dimension by dimension. Regression is
    one-sided: getting FASTER / dispatching LESS never trips."""
    th = thresholds or Thresholds()
    report = DoctorReport()

    def frac_row(dim, b, c, tol, higher_is_better=False, note=""):
        if b is None or c is None:
            report.skipped.append(dim)
            return
        if b == 0:
            regressed = c > 0 and not higher_is_better
        elif higher_is_better:
            regressed = c < b * (1.0 - tol)
        else:
            regressed = c > b * (1.0 + tol)
        report.rows.append(
            DiffRow(dim, b, c, f"±{tol:.0%}", regressed, note)
        )

    def abs_row(dim, b, c, tol, note=""):
        if b is None or c is None:
            report.skipped.append(dim)
            return
        report.rows.append(
            DiffRow(dim, b, c, f"+{tol}", c > b + tol, note)
        )

    unit = str(cand.get("unit") or base.get("unit") or "")
    frac_row(
        f"value ({unit})",
        _num(base, "value"),
        _num(cand, "value"),
        th.value_frac,
        higher_is_better=unit in _RATE_UNITS,
        note=str(base.get("metric", ""))[:60],
    )
    abs_row(
        "jax_dispatches",
        _num(base, "obs", "jax_dispatches"),
        _num(cand, "obs", "jax_dispatches"),
        th.dispatch_abs,
        note="device dispatches are semantic on a fixed scenario",
    )
    abs_row(
        "jax_recompiles",
        _num(base, "obs", "jax_recompiles"),
        _num(cand, "obs", "jax_recompiles"),
        th.recompile_abs,
        note="one per shape-signature; growth = warm-cache regression",
    )
    frac_row(
        "ledger.peak_bytes",
        _num(base, "obs", "ledger", "peak_bytes"),
        _num(cand, "obs", "ledger", "peak_bytes"),
        th.hbm_frac,
        note="peak device memory (obs/ledger.py watermark)",
    )
    # incremental / artifact-store families (r15): optional blocks —
    # absent from BOTH sides means the scenario never exercised them
    # (silently not-applicable, not a noteworthy skip); absent from
    # ONE side reports as skipped like every other dimension
    def opt(row_fn, dim, b, c, tol, **kw):
        if b is None and c is None:
            return
        row_fn(dim, b, c, tol, **kw)

    opt(
        frac_row,
        "incremental.suffix_fraction",
        _num(base, "obs", "incremental", "suffix_fraction"),
        _num(cand, "obs", "incremental", "suffix_fraction"),
        th.suffix_frac,
        note="re-dispatched rows / (re-dispatched + prefix-reused)",
    )
    opt(
        frac_row,
        "aot_store.hit_rate",
        _num(base, "obs", "aot_store", "hit_rate"),
        _num(cand, "obs", "aot_store", "hit_rate"),
        th.store_frac,
        higher_is_better=True,
        note="store loads / (loads + compile misses)",
    )
    opt(
        abs_row,
        "aot_store.rejects",
        _num(base, "obs", "aot_store", "rejects"),
        _num(cand, "obs", "aot_store", "rejects"),
        th.store_reject_abs,
        note="corrupt/stale store entries refused (each one recompiles)",
    )
    opt(
        frac_row,
        "fleet.qps_scaling",
        _num(base, "obs", "fleet", "qps_scaling"),
        _num(cand, "obs", "fleet", "qps_scaling"),
        th.fleet_frac,
        higher_is_better=True,
        note="aggregate fleet QPS at max replicas / single-replica QPS",
    )
    opt(
        frac_row,
        "fleet.failover_seconds",
        _num(base, "obs", "fleet", "failover_seconds"),
        _num(cand, "obs", "fleet", "failover_seconds"),
        th.fleet_frac,
        note="kill-9 to next 200 through the router (reroute latency)",
    )
    # the audited per-phase breakdown of that total (fleet/audit.py):
    # a regressed total names its slow phase instead of one number.
    # Older baselines (BENCH_r13-era) predate the audit — absent from
    # both sides, the rows silently skip and the total is still gated.
    for phase in ("detect", "reclaim", "respawn", "replay", "first_200"):
        opt(
            frac_row,
            f"fleet.failover_phases.{phase}",
            _num(base, "obs", "fleet", "failover_phases", phase),
            _num(cand, "obs", "fleet", "failover_phases", phase),
            th.fleet_frac,
            note="audited failover phase (fleet/audit.py timeline)",
        )
    opt(
        frac_row,
        "ckpt.restore_seconds",
        _num(base, "obs", "ckpt", "restore_seconds"),
        _num(cand, "obs", "ckpt", "restore_seconds"),
        th.ckpt_frac,
        note="aged-failover restore: newest checkpoint + journal suffix",
    )
    # per-site latency p95s: every site present in BOTH records
    bh = base.get("obs", {}).get("histograms")
    ch = cand.get("obs", {}).get("histograms")
    if isinstance(bh, dict) and isinstance(ch, dict):
        for site in sorted(set(bh) & set(ch)):
            frac_row(
                f"p95 {site}",
                _num(bh, site, "p95_ms"),
                _num(ch, site, "p95_ms"),
                th.p95_frac,
            )
    elif bh or ch:
        report.skipped.append("histograms")
    return report


def render_text(report: DoctorReport, base_name: str, cand_name: str) -> str:
    w = max(
        [len(r.dimension) for r in report.rows] + [len("dimension")]
    )
    lines = [
        f"simon doctor: {cand_name} vs baseline {base_name}",
        f"{'dimension':<{w}}  {'baseline':>14}  {'candidate':>14}  "
        f"{'threshold':>9}  verdict",
    ]
    for r in report.rows:
        verdict = "REGRESSED" if r.regressed else "ok"
        lines.append(
            f"{r.dimension:<{w}}  {r.baseline:>14.6g}  "
            f"{r.candidate:>14.6g}  {r.threshold:>9}  {verdict}"
        )
    if report.skipped:
        lines.append(
            f"skipped (absent from one side): {', '.join(report.skipped)}"
        )
    lines.append(
        "RESULT: "
        + (
            "ok — no regression past thresholds"
            if report.ok
            else f"{len(report.regressions)} regression(s): "
            + ", ".join(r.dimension for r in report.regressions)
        )
    )
    return "\n".join(lines)
