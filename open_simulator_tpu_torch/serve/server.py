"""`simon serve` — the long-lived what-if scheduling daemon.

JSON-over-HTTP API (docs/SERVING.md):

- ``POST /v1/simulate`` — body is either a JSON object
  ``{"apps": [{"name": ..., "yaml": "..."}], "deadlineSeconds": N,
  "trace": bool}`` or raw YAML (treated as one unnamed app). Replies
  200 with the canonical simulate answer (byte-identical to a
  standalone ``simulate()`` of the same request), 400 on undecodable
  input, 503 with a machine-readable PARTIAL body when shed
  (queue full / draining / queue-expired deadline).
- ``GET /healthz`` — liveness + the loaded cluster's fingerprint.
- ``GET /metrics`` — Prometheus text: QPS, queue depth, batch fill,
  latency p50/p95, shed and dispatch counters.

Lifecycle: SIGTERM (or SIGINT) stops intake, drains in-flight and
queued requests through the coalescer, and exits 0; if
``--drain-timeout`` expires first, leftovers are shed and the exit
code is 3 (the deadline-partial code — docs/ROBUSTNESS.md).

The port's copy of the JAX package's serve/server.py: the same
endpoints, status codes, bodies and ``Retry-After`` rules. ``/metrics``
renders what the port counts, under names without the compiler's:
launches per site, nvcc builds and cache hits, and the cost records of
obs/costs.py, in place of the JAX package's dispatch, recompile and
compiled-cost families.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..models.decode import ResourceTypes, decode_yaml_content
from ..obs import telemetry
from ..runtime.budget import Budget
from ..runtime.errors import EXIT_OK, EXIT_PARTIAL_DEADLINE
from ..scheduler.core import AppResource
from ..utils.trace import COUNTERS
from .admission import (
    AdmissionController,
    estimate_request_pods,
    sanitize_tenant,
)
from .coalescer import Coalescer, PendingRequest
from .session import Session, WhatIfRequest
from .sessions import SessionCache, open_snapshot

log = logging.getLogger(__name__)

# wait bound for a handler thread whose request IS being evaluated: the
# dispatcher always answers (even shed/error paths), so this only trips
# if the dispatcher thread died — answer 500 instead of hanging the
# client transport forever
_RESULT_WAIT_SLACK_S = 600.0


def parse_request_body(raw: bytes, content_type: str):
    """-> (WhatIfRequest, deadline_s or None, want_trace). Raises
    ValueError on undecodable input (the handler answers 400).

    The JSON envelope is recognized by Content-Type OR by shape (a
    JSON object with an "apps" key): a client that forgets the
    Content-Type header must not have its envelope silently YAML-
    decoded into an empty workload and answered 200 "success" —
    a wrong answer indistinguishable from "everything fits"."""
    deadline = None
    want_trace = False
    doc = None
    if "json" in (content_type or "").lower():
        try:
            doc = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise ValueError(f"body is not valid JSON: {e}") from e
        if not isinstance(doc, dict):
            raise ValueError("JSON body must be an object")
    else:
        try:
            sniffed = json.loads(raw.decode("utf-8"))
            if isinstance(sniffed, dict) and "apps" in sniffed:
                doc = sniffed
        except (UnicodeDecodeError, ValueError):  # noqa: S110 - sniff only: a non-JSON body is the normal raw-YAML case, decoded (with real errors) just below
            pass
    if doc is not None:
        if doc.get("deadlineSeconds") is not None:
            deadline = float(doc["deadlineSeconds"])
            if deadline <= 0:
                raise ValueError("deadlineSeconds must be > 0")
        want_trace = bool(doc.get("trace", False))
        apps_spec = doc.get("apps")
        if not isinstance(apps_spec, list) or not apps_spec:
            raise ValueError('JSON body needs a non-empty "apps" list')
        apps: List[AppResource] = []
        for i, a in enumerate(apps_spec):
            if not isinstance(a, dict) or not isinstance(a.get("yaml"), str):
                raise ValueError(f'apps[{i}] needs a "yaml" string')
            apps.append(
                AppResource(
                    name=str(a.get("name") or f"app-{i}"),
                    resource=_decode_app_yaml(a["yaml"], i),
                )
            )
        return (
            WhatIfRequest(
                apps=apps, tenant=sanitize_tenant(doc.get("tenant"))
            ),
            deadline,
            want_trace,
        )
    # raw YAML: one unnamed app
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"body is not UTF-8 YAML: {e}") from e
    resource = _decode_app_yaml(text, 0)
    if all(not getattr(resource, f) for f in vars(resource)):
        # parsed, but nothing simulatable: almost certainly a malformed
        # request (unknown kinds, or a JSON envelope that failed the
        # shape sniff) — a 200 for an empty workload would be a wrong
        # answer, not an answer
        raise ValueError(
            "body decoded to no recognized Kubernetes objects; send "
            'either k8s YAML or the {"apps": [...]} JSON envelope'
        )
    return (
        WhatIfRequest(apps=[AppResource(name="app-0", resource=resource)]),
        deadline,
        want_trace,
    )


def _decode_app_yaml(text: str, i: int) -> ResourceTypes:
    import yaml

    try:
        return decode_yaml_content([text])
    except yaml.YAMLError as e:
        raise ValueError(f"apps[{i}]: invalid YAML: {e}") from e


def render_metrics(coalescer: Coalescer, slo_engine=None) -> bytes:
    """Prometheus text exposition of the process-wide counters
    (utils/trace.COUNTERS)."""
    snap = COUNTERS.snapshot()
    counts = snap["counts"]
    lines = []

    def metric(name, kind, help_text, value):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    metric(
        "simon_serve_requests_total", "counter",
        "Requests answered (any status).", counts.get("serve_requests_total", 0),
    )
    metric(
        "simon_serve_shed_total", "counter",
        "Requests shed (overload, drain, or queue-expired deadline).",
        counts.get("serve_shed_total", 0),
    )
    metric(
        "simon_serve_shed_overload_total", "counter",
        "Sheds due to a full queue.", counts.get("serve_shed_overload_total", 0),
    )
    metric(
        "simon_serve_shed_deadline_total", "counter",
        "Sheds due to a deadline that expired in the queue.",
        counts.get("serve_shed_deadline_total", 0),
    )
    metric(
        "simon_serve_device_dispatches_total", "counter",
        "Batched device dispatches (one per coalesced scan chunk).",
        counts.get("serve_device_dispatches_total", 0),
    )
    metric(
        "simon_serve_batches_total", "counter",
        "Coalescer ticks that evaluated at least one request.",
        counts.get("serve_batches_total", 0),
    )
    metric(
        "simon_serve_batch_errors_total", "counter",
        "Coalescer ticks that failed and answered 500.",
        counts.get("serve_batch_errors_total", 0),
    )
    metric(
        "simon_serve_queue_depth", "gauge",
        "Requests currently queued.", coalescer.depth,
    )
    metric(
        "simon_serve_batch_fill_mean", "gauge",
        "Mean requests per coalesced tick (recent window).",
        round(COUNTERS.mean("serve_batch_fill"), 4),
    )
    metric(
        "simon_serve_qps", "gauge",
        "Completions per second over the trailing 60s.",
        round(COUNTERS.rate("serve_completions"), 4),
    )
    metric(
        "simon_serve_latency_p50_seconds", "gauge",
        "Median request latency (recent window).",
        round(COUNTERS.percentile("serve_latency_seconds", 50), 6),
    )
    metric(
        "simon_serve_latency_p95_seconds", "gauge",
        "p95 request latency (recent window).",
        round(COUNTERS.percentile("serve_latency_seconds", 95), 6),
    )
    # instrumented launches (obs/profile.py) and kernel builds
    # (utils/nvcc.py): the same registry the trace artifacts read
    metric(
        "simon_launches_total", "counter",
        "Instrumented launches of device work (kernels, or their plain "
        "versions on the CPU).",
        counts.get("launches_total", 0),
    )
    metric(
        "simon_device_launches_total", "counter",
        "Instrumented launches on the card.",
        counts.get("device_launches_total", 0),
    )
    sites = sorted(
        k[len("launches_"):] for k in counts
        if k.startswith("launches_") and k != "launches_total"
    )
    lines.append(
        "# HELP simon_launches_site_total Instrumented launches per site."
    )
    lines.append("# TYPE simon_launches_site_total counter")
    for site in sites:
        lines.append(
            f'simon_launches_site_total{{site="{site}"}} '
            f"{counts[f'launches_{site}']}"
        )
    metric(
        "simon_nvcc_builds_total", "counter",
        "Kernel sources compiled by nvcc in this process.",
        counts.get("nvcc_builds_total", 0),
    )
    metric(
        "simon_nvcc_cache_hits_total", "counter",
        "Kernel libraries found already built.",
        counts.get("nvcc_cache_hits_total", 0),
    )
    metric(
        "simon_device_transfer_d2h_bytes_total", "counter",
        "Bytes materialized host-side from device outputs.",
        counts.get("device_transfer_d2h_bytes_total", 0),
    )
    metric(
        "simon_device_transfer_h2d_bytes_total", "counter",
        "Bytes shipped to the device (scenario masks and friends).",
        counts.get("device_transfer_h2d_bytes_total", 0),
    )
    # shadow divergence auditor (shadow/replay.py): zero until a shadow
    # replay runs in this process, but always exported so dashboards
    # can rely on the series existing
    for key, help_text in (
        ("shadow_steps_total", "Shadow replay steps applied (decisions + deltas)."),
        ("shadow_decisions_total", "Real scheduler decisions replayed."),
        ("shadow_agree_total", "Replayed decisions simon agreed with."),
        ("shadow_divergence_total", "Replayed decisions simon diverged on."),
        ("shadow_divergence_node_total", "Node-divergences (same pod, different node)."),
        ("shadow_divergence_feasibility_total", "Feasibility-divergences (one side unschedulable)."),
        ("shadow_divergence_ordering_total", "Ordering-divergences (preemption/arrival-order evidence)."),
        ("shadow_warm_builds_total", "nvcc builds on an already-seen replay shape."),
        ("shadow_reloads_total", "Replay state reloads forced by node removal."),
        ("shadow_delta_skips_total", "Cluster-delta ops skipped (stale live-tail races)."),
        ("shadow_ingest_event_decisions_total", "Tail decisions sourced from scheduler Event objects."),
        ("shadow_ingest_diff_decisions_total", "Tail decisions inferred from pod diffs alone."),
        ("shadow_ingest_event_mismatch_total", "Scheduled events whose node contradicted the pod spec."),
        ("shadow_ingest_events_unsupported_total", "Events endpoints that failed the one-time probe."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    metric(
        "simon_shadow_agreement_rate", "gauge",
        "Agreement rate of the most recent shadow replay (1.0 = full).",
        snap["gauges"].get("shadow_agreement_rate", 1.0),
    )
    lines.extend(_resilience_lines(snap))
    lines.extend(_observatory_lines(snap))
    lines.extend(_telemetry_lines(snap, slo_engine))
    lines.append("")
    return "\n".join(lines).encode()


def _telemetry_lines(snap: dict, slo_engine=None) -> List[str]:
    """Production-telemetry exposition shared by serve and twin
    (docs/OBSERVABILITY.md): span-recorder truncation, series-store
    occupancy, and the ``simon_slo_*`` burn-rate block when an SLO
    config is loaded."""
    from ..obs.spans import RECORDER

    counts = snap["counts"]
    lines: List[str] = []

    def metric(name, kind, help_text, value):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    metric(
        "simon_spans_dropped_total", "counter",
        "Spans lost to the recorder cap (cap mode) or overwritten "
        "oldest-first (ring mode) — nonzero means exported traces are "
        "a window, not the whole run.",
        counts.get("spans_dropped_total", 0),
    )
    metric(
        "simon_obs_series", "gauge",
        "Signals resident in the telemetry ring store.",
        telemetry.SERIES.stats()["series"],
    )
    metric(
        "simon_obs_spans_resident", "gauge",
        "Spans currently held by the flight recorder.",
        RECORDER.count if RECORDER.enabled else 0,
    )
    metric(
        "simon_telemetry_sample_errors_total", "counter",
        "Telemetry sampling passes that failed (loop survives them).",
        counts.get("telemetry_sample_errors_total", 0),
    )
    if slo_engine is not None:
        lines.extend(slo_engine.prometheus_lines())
    return lines


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _resilience_lines(snap: dict) -> List[str]:
    """Circuit-breaker / retry / watchdog / admission / session-cache
    exposition (docs/ROBUSTNESS.md, docs/SERVING.md): the degradation
    machinery's own state, so 'is the daemon degraded and why' is one
    scrape, not a log dive."""
    from ..runtime.retry import breaker_states

    counts = snap["counts"]
    gauges = snap["gauges"]
    lines: List[str] = []

    def metric(name, kind, help_text, value):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    # -- circuit breakers (runtime/retry.py)
    states = breaker_states()
    lines.append(
        "# HELP simon_breaker_state Circuit-breaker state per endpoint "
        "(0 closed, 1 open, 0.5 half-open probe window)."
    )
    lines.append("# TYPE simon_breaker_state gauge")
    for endpoint, st in sorted(states.items()):
        lines.append(
            f'simon_breaker_state{{endpoint="{_escape_label(endpoint)}"}} '
            f"{st['state']}"
        )
    for key, help_text in (
        ("breaker_opens_total", "Circuit-breaker open transitions."),
        ("breaker_recloses_total", "Breakers re-closed after a successful half-open probe."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    # -- retry attempts (per endpoint only: a bare aggregate sample in
    # the same family would make sum() over the family double-count)
    lines.append(
        "# HELP simon_retry_attempts_total Failed I/O attempts that "
        "entered the retry/backoff path, per endpoint."
    )
    lines.append("# TYPE simon_retry_attempts_total counter")
    ep_keys = sorted(
        k for k in counts if k.startswith("retry_attempts_ep:")
    )
    for key in ep_keys:
        endpoint = key.split(":", 1)[1]
        lines.append(
            f'simon_retry_attempts_total{{endpoint="{_escape_label(endpoint)}"}} '
            f"{counts[key]}"
        )
    if not ep_keys:
        # zero-activity daemons still expose the family (scrape
        # continuity): one sample, no endpoint has retried yet
        lines.append(
            f'simon_retry_attempts_total{{endpoint=""}} '
            f"{counts.get('retry_attempts_total', 0)}"
        )
    # -- dispatcher watchdog (serve/coalescer.py)
    for key, help_text in (
        ("serve_watchdog_restarts_total", "Dispatcher threads restarted by the watchdog."),
        ("serve_dispatcher_casualties_total", "In-flight requests failed typed by a dispatcher death."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    # -- admission control (serve/admission.py)
    for key, help_text in (
        ("serve_admission_total", "Admission verdicts issued."),
        ("serve_admission_serial_total", "Requests serially routed by admission (predicted device memory / oversize)."),
        ("serve_admission_shed_total", "Requests shed 429 by admission (predicted latency past the tick budget)."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    # -- per-tenant accounting
    for prefix, name, help_text in (
        ("serve_tenant_requests:", "simon_serve_tenant_requests_total",
         "Requests received per tenant (any verdict)."),
        ("serve_tenant_shed:", "simon_serve_tenant_shed_total",
         "Requests shed per tenant (admission 429 + overload/drain 503)."),
    ):
        keys = sorted(k for k in counts if k.startswith(prefix))
        if keys:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} counter")
            for key in keys:
                tenant = key.split(":", 1)[1]
                lines.append(
                    f'{name}{{tenant="{_escape_label(tenant)}"}} {counts[key]}'
                )
    # -- warm-session cluster deltas (/v1/cluster-delta, twin substrate)
    for key, help_text in (
        ("serve_deltas_applied_total", "Cluster deltas applied to the warm session."),
        ("serve_delta_skips_total", "Deltas skipped (no matching roster pod / known node)."),
        ("serve_delta_reloads_total", "Deltas that rebuilt the session (node drains; daemonset node churn)."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    # -- session cache (serve/sessions.py)
    metric(
        "simon_serve_sessions", "gauge",
        "Warm sessions resident in the LRU.", gauges.get("serve_sessions", 1),
    )
    metric(
        "simon_serve_session_evictions_total", "counter",
        "Warm sessions evicted (capacity + ledger pressure).",
        counts.get("serve_session_evictions_total", 0),
    )
    # -- bounded-recovery checkpoints (runtime/checkpoint.py)
    for key, help_text in (
        ("ckpt_writes_total", "Verified checkpoint generations written."),
        ("ckpt_write_errors_total", "Checkpoint attempts that failed (write or verify); the previous generation stays authoritative."),
        ("ckpt_verify_failures_total", "Written snapshots whose digest did NOT re-materialize — refused and deleted, never compacted against."),
        ("ckpt_compactions_total", "Journal compactions after a verified checkpoint."),
        ("ckpt_compacted_records_total", "Journal records truncated as absorbed by a verified checkpoint."),
        ("ckpt_compact_errors_total", "Compaction failures (journal left intact; replay stays seq-bounded)."),
        ("ckpt_pruned_total", "Old checkpoint generations removed by the --keep-checkpoints policy."),
        ("ckpt_restore_total", "Bootstraps that restored from a verified checkpoint."),
        ("ckpt_restore_fallback_total", "Checkpoint generations refused at restore (torn/corrupt/stale) — fell back to an older one or full replay."),
        ("ckpt_restore_deltas_skipped_total", "Journal delta records skipped at restore as absorbed by the checkpoint."),
        ("fleet_replay_deltas_total", "Journal delta records actually replayed at restore (the bounded suffix)."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    for key, help_text in (
        ("ckpt_restore_seconds", "Wall-clock of the last checkpoint restore (snapshot load + verify + suffix replay)."),
        ("ckpt_write_seconds", "Wall-clock of the last checkpoint write + verify."),
    ):
        if key in gauges:
            metric(f"simon_{key}", "gauge", help_text, gauges[key])
    # -- fault injection (runtime/inject.py): nonzero only when armed
    metric(
        "simon_inject_fired_total", "counter",
        "Chaos faults fired by the armed SIMON_INJECT spec (0 in production).",
        counts.get("inject_fired_total", 0),
    )
    return lines


def _observatory_lines(snap: dict) -> List[str]:
    """Launch-cost / memory-ledger / latency-histogram exposition
    (docs/OBSERVABILITY.md): the ``simon_cost_*`` per-site gauges from
    the cost records of obs/costs.py (counted from each launch's plan:
    bytes moved, operations, workspace), the device-memory gauges and
    predictive-split counters, per-site latency histograms with
    p50/p95/p99, and the top spans by exclusive time when the span
    recorder is armed (--trace-out)."""
    from ..obs import histo, spans
    from ..obs.costs import COSTS

    counts, gauges = snap["counts"], snap["gauges"]
    lines: List[str] = []

    def metric(name, kind, help_text, value):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    # -- launch cost records (obs/costs.py)
    sites = COSTS.sites()
    if sites:
        for field, help_text in (
            ("bytes", "Bytes the site's last recorded launch shape must move."),
            ("ops", "Operations the site's last recorded launch shape needs."),
            ("workspace_bytes", "Device bytes one launch of the site's last recorded shape allocates."),
        ):
            lines.append(f"# HELP simon_cost_{field} {help_text}")
            lines.append(f"# TYPE simon_cost_{field} gauge")
            for site in sites:
                lines.append(
                    f'simon_cost_{field}{{site="{site}"}} '
                    f"{gauges.get(f'cost_{field}_{site}', 0)}"
                )
        lines.append(
            "# HELP simon_cost_signatures Recorded launch shapes per site."
        )
        lines.append("# TYPE simon_cost_signatures gauge")
        for site in sites:
            lines.append(
                f'simon_cost_signatures{{site="{site}"}} '
                f"{len(COSTS.records_for(site))}"
            )
    metric(
        "simon_cost_records_total", "counter",
        "Cost records made (one per new launch shape per site).",
        counts.get("cost_records_total", 0),
    )
    metric(
        "simon_cost_bytes_launched_total", "counter",
        "Bytes moved, summed over every recorded launch.",
        counts.get("cost_bytes_launched_total", 0),
    )
    metric(
        "simon_cost_ops_launched_total", "counter",
        "Operations, summed over every recorded launch.",
        counts.get("cost_ops_launched_total", 0),
    )
    # -- the kernel-library store (incremental/store.py)
    metric(
        "simon_aot_store_hit_total", "counter",
        "Kernel libraries loaded from the persistent store instead of "
        "built by nvcc (--aot-store).",
        counts.get("aot_store_hit_total", 0),
    )
    metric(
        "simon_aot_store_miss_total", "counter",
        "Store probes that found no entry (the library was built).",
        counts.get("aot_store_miss_total", 0),
    )
    metric(
        "simon_aot_store_reject_total", "counter",
        "Store entries refused loudly: torn or unparseable manifest, "
        "digest mismatch, corrupt payload — each one rebuilt by nvcc.",
        counts.get("aot_store_reject_total", 0),
    )
    metric(
        "simon_aot_store_save_total", "counter",
        "Kernel libraries saved into the store (temporary + rename).",
        counts.get("aot_store_save_total", 0),
    )
    # -- delta re-simulation (incremental/resim.py)
    metric(
        "simon_incremental_suffix_pods_total", "counter",
        "Pod rows actually re-dispatched by incremental paths (what-if "
        "suffixes, delta re-simulations, timeline window free rows).",
        counts.get("incremental_suffix_pods_total", 0),
    )
    metric(
        "simon_incremental_prefix_reused_pods_total", "counter",
        "Pod rows whose committed placements were reused instead of "
        "re-scanned.",
        counts.get("incremental_prefix_reused_pods_total", 0),
    )
    metric(
        "simon_incremental_resims_total", "counter",
        "Suffix re-simulations applied to a committed scan.",
        counts.get("incremental_resims_total", 0),
    )
    metric(
        "simon_incremental_full_rebuilds_total", "counter",
        "Committed-scan full re-scans (conservative rule or degraded "
        "fault path; results identical either way).",
        counts.get("incremental_full_rebuilds_total", 0),
    )
    metric(
        "simon_incremental_fallbacks_total", "counter",
        "Classified faults that degraded an incremental path to the "
        "full one.",
        counts.get("incremental_fallbacks_total", 0),
    )
    # -- device-memory ledger (obs/ledger.py)
    metric(
        "simon_device_mem_bytes_in_use", "gauge",
        "Device bytes in use at the last ledger poll.",
        gauges.get("device_mem_bytes_in_use", 0),
    )
    metric(
        "simon_device_mem_peak_bytes", "gauge",
        "Peak device bytes observed by the ledger this process.",
        gauges.get("device_mem_peak_bytes", 0),
    )
    # per-device rows: every card polled (the launches' and each watched
    # mesh device), labeled: a sharded launch lives or dies on the
    # tightest one
    from ..obs.ledger import LEDGER

    per_device = LEDGER.device_summary()
    if per_device:
        lines.append(
            "# HELP simon_device_mem_device_bytes_in_use Device bytes in "
            "use at the last ledger poll, per device."
        )
        lines.append("# TYPE simon_device_mem_device_bytes_in_use gauge")
        for row in per_device:
            lines.append(
                f'simon_device_mem_device_bytes_in_use{{device="{row["device"]}"}} '
                f"{row['in_use']}"
            )
        if any(row.get("limit") for row in per_device):
            lines.append(
                "# HELP simon_device_mem_device_bytes_limit Per-device "
                "allocator budget (or the even SIMON_DEVICE_MEM_BUDGET slice)."
            )
            lines.append("# TYPE simon_device_mem_device_bytes_limit gauge")
            for row in per_device:
                if row.get("limit"):
                    lines.append(
                        f'simon_device_mem_device_bytes_limit{{device="{row["device"]}"}} '
                        f"{row['limit']}"
                    )
    for key, help_text in (
        ("ledger_predictions_total", "predict_fit verdicts issued."),
        ("ledger_predict_fit_total", "Launches predicted to fit."),
        ("ledger_predict_unfit_total", "Launches predicted NOT to fit (split before launch)."),
        ("ledger_predict_hit_total", "Predicted-fit chunks that ran without OOM."),
        ("ledger_predict_miss_total", "Predicted-fit chunks that OOMed anyway."),
        ("guard_oom_predicted_total", "Chunks split predictively, zero doomed launches."),
        ("guard_oom_reactive_total", "Device OOMs caught reactively (the halving fallback)."),
        ("mesh_layout_scenario_total", "Dispatches the layout planner sharded on the scenario axis."),
        ("mesh_layout_node_total", "Dispatches the layout planner sharded on the node axis."),
        ("mesh_layout_none_total", "Dispatches the planner kept on the single-device ladder."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    # -- latency histograms (obs/histo.py)
    lines.extend(histo.prometheus_lines())
    # -- hot spans by exclusive time (span recorder armed only);
    # cached: the always-armed daemon ring must not be copied and
    # walked per scrape (spans.top_spans_cached, 30s refresh)
    if spans.RECORDER.enabled:
        top = spans.top_spans_cached(5)
        if top:
            lines.append(
                "# HELP simon_span_exclusive_seconds Top spans by exclusive "
                "(self) wall-clock since the recorder was armed."
            )
            lines.append("# TYPE simon_span_exclusive_seconds gauge")
            for row in top:
                lines.append(
                    f'simon_span_exclusive_seconds{{span="{row["name"]}"}} '
                    f"{row['exclusive_ms'] / 1e3:.6f}"
                )
    return lines


class ServeDaemon:
    """Owns the HTTP server, the coalescer, and the drain lifecycle."""

    def __init__(
        self,
        session: Session,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_batch: int = 16,
        queue_depth: int = 64,
        default_deadline_s: Optional[float] = None,
        drain_timeout_s: float = 30.0,
        tick_budget_s: Optional[float] = None,
        max_request_pods: Optional[int] = None,
        max_sessions: int = 8,
        snapshot_path: Optional[str] = None,
        checkpoint_interval: Optional[int] = None,
        keep_checkpoints: int = 2,
        slo_engine=None,
        obs_cadence_s: float = 1.0,
    ):
        self.session = session
        self.default_deadline_s = default_deadline_s
        self.drain_timeout_s = drain_timeout_s
        self.slo_engine = slo_engine
        # the resident telemetry loop: counters/gauges/percentiles/
        # ledger into the series rings on a cadence, SLO evaluation
        # riding each sample (obs/telemetry.py)
        self.telemetry = telemetry.TelemetryRuntime(
            cadence_s=obs_cadence_s, slo_engine=slo_engine
        )
        self.admission = AdmissionController(
            max_batch=max_batch,
            tick_budget_s=tick_budget_s,
            max_request_pods=max_request_pods,
        )
        snapshot = open_snapshot(snapshot_path) if snapshot_path else None
        self.sessions = SessionCache(capacity=max_sessions, snapshot=snapshot)
        # bounded-recovery checkpoints (runtime/checkpoint.py): verified
        # snapshots of the committed session every --checkpoint-interval
        # deltas, journal compacted to the unabsorbed suffix — replay on
        # the NEXT bootstrap is O(interval), not O(lifetime)
        self.checkpoints = None
        if snapshot is not None and checkpoint_interval:
            from ..runtime.checkpoint import CheckpointManager, checkpoint_dir
            from .session import session_checkpoint_state, verify_payload_digest
            from .sessions import serve_keep_record

            self.checkpoints = CheckpointManager(
                checkpoint_dir(snapshot_path),
                interval=checkpoint_interval,
                keep=keep_checkpoints,
                capture=lambda: session_checkpoint_state(self.session),
                materialized_digest=lambda payload: verify_payload_digest(
                    self.session, payload
                ),
                journal=snapshot,
                keep_record=serve_keep_record(session.fingerprint),
                label="serve",
            )
        # the configured cluster is pinned: ledger pressure and
        # capacity evict secondaries only (serve/sessions.py)
        self.sessions.add(session, pinned=True)
        self.coalescer = Coalescer(
            session,
            max_batch=max_batch,
            queue_depth=queue_depth,
            on_tick=self.sessions.check_pressure,
        )
        self._shutdown = threading.Event()
        # simulate requests currently inside do_POST (parse -> reply
        # WRITTEN): the drain waits for this to reach zero so "exit 0"
        # really means every answered request reached its client's
        # socket, not just the coalescer (handler threads are daemonic
        # and would otherwise die mid-write at process exit)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._inflight_zero = threading.Event()
        self._inflight_zero.set()
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # stdlib logs to stderr per request
                log.debug("%s %s", self.address_string(), fmt % args)

            def _send(self, status: int, body: bytes, content_type="application/json", headers=()):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    status, reasons = daemon.readiness()
                    # degraded readiness advertises the SAME backoff
                    # hint as the admission 429 path, so probers (the
                    # fleet router, external LBs) back off uniformly
                    # with shed clients instead of hot-looping
                    hdrs = ()
                    retry_after = None
                    if reasons:
                        retry_after = daemon.admission.retry_after_hint(
                            daemon.coalescer.depth
                        )
                        hdrs = (("Retry-After", str(retry_after)),)
                    self._send(
                        200,
                        json.dumps(
                            {
                                "ok": True,
                                "status": status,
                                "degraded": bool(reasons),
                                "reasons": reasons,
                                "retryAfterSeconds": retry_after,
                                "cluster": daemon.session.fingerprint,
                                "deltaSeq": daemon.session.delta_seq,
                                "queueDepth": daemon.coalescer.depth,
                                "sessions": daemon.sessions.stats(),
                                "sloAlerting": (
                                    daemon.slo_engine.alerting()
                                    if daemon.slo_engine is not None
                                    else []
                                ),
                                "checkpoint": (
                                    daemon.checkpoints.stats()
                                    if daemon.checkpoints is not None
                                    else None
                                ),
                                "draining": daemon._shutdown.is_set(),
                            }
                        ).encode(),
                        headers=hdrs,
                    )
                elif self.path == "/v1/state-digest":
                    # the fleet dict-identity gate (docs/FLEET.md): a
                    # replacement replica is correct iff this triple
                    # matches the replica it replaced
                    self._send(
                        200,
                        json.dumps(
                            {
                                "fingerprint": daemon.session.fingerprint,
                                "deltaSeq": daemon.session.delta_seq,
                                "stateDigest": daemon.session.state_digest(),
                            },
                            sort_keys=True,
                        ).encode(),
                    )
                elif self.path == "/metrics":
                    self._send(
                        200,
                        render_metrics(daemon.coalescer, daemon.slo_engine),
                        content_type="text/plain; version=0.0.4",
                    )
                elif self.path.startswith("/v1/obs/series"):
                    status, doc = telemetry.series_endpoint(self.path)
                    self._send(
                        status,
                        json.dumps(doc, sort_keys=True).encode(),
                    )
                elif self.path == "/v1/obs/snapshot":
                    self._send(
                        200,
                        json.dumps(
                            telemetry.snapshot_doc(
                                daemon.slo_engine,
                                runtime=daemon.telemetry,
                                extra={
                                    "daemon": "serve",
                                    "health": daemon.readiness()[0],
                                    "queueDepth": daemon.coalescer.depth,
                                },
                            ),
                            sort_keys=True,
                        ).encode(),
                    )
                else:
                    self._send(404, json.dumps({"error": "not found"}).encode())

            def do_POST(self):
                if self.path == "/v1/cluster-delta":
                    self._do_cluster_delta()
                    return
                if self.path == "/debug/dump":
                    length = int(self.headers.get("Content-Length") or 0)
                    status, doc = telemetry.handle_debug_dump(
                        self.rfile.read(length),
                        slo_engine=daemon.slo_engine,
                        runtime=daemon.telemetry,
                        label="serve",
                    )
                    self._send(
                        status, json.dumps(doc, sort_keys=True).encode()
                    )
                    return
                if self.path != "/v1/simulate":
                    self._send(404, json.dumps({"error": "not found"}).encode())
                    return
                with daemon._inflight_lock:
                    daemon._inflight += 1
                    daemon._inflight_zero.clear()
                try:
                    self._do_simulate()
                finally:
                    with daemon._inflight_lock:
                        daemon._inflight -= 1
                        if daemon._inflight == 0:
                            daemon._inflight_zero.set()

            def _do_cluster_delta(self):
                """POST /v1/cluster-delta: apply a ClusterDelta stream
                (twin/deltas.py vocabulary) to the warm primary
                session — the watch-style delta update.
                Body: one delta record or ``{"deltas": [...]}``. Every
                record FULLY validates before any applies — shape,
                pod validity, and node-reference consistency walked
                against the session's node set — so a typo'd stream
                mutates nothing (400); each applied delta journals to
                the session snapshot (--snapshot), so a restarted
                daemon can see what its warm state had absorbed."""
                import copy as _copy

                from ..models import workloads as _wl
                from ..models.validation import InputError
                from ..twin import deltas as _dl
                from ..twin.deltas import ClusterDelta

                rid = telemetry.ensure_request_id(
                    self.headers.get(telemetry.REQUEST_ID_HEADER)
                )
                rid_header = (telemetry.REQUEST_ID_HEADER, rid)
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                try:
                    doc = json.loads(raw.decode("utf-8"))
                    if isinstance(doc, dict) and "deltas" in doc:
                        recs = doc["deltas"]
                    elif isinstance(doc, dict):
                        recs = [doc]
                    else:
                        raise InputError(
                            'body must be a delta object or {"deltas": [...]}'
                        )
                    if not isinstance(recs, list) or not recs:
                        raise InputError('"deltas" must be a non-empty list')
                    deltas = [ClusterDelta.from_record(r) for r in recs]
                    # node-reference consistency over the stream
                    # (joins add, drains need presence) and pod
                    # validity — the apply loop re-runs the same
                    # validation, so this pre-pass makes the 400 path
                    # mutation-free without forking semantics
                    names = {
                        (n.get("metadata") or {}).get("name")
                        for n in daemon.session.cluster.nodes
                    }
                    for d in deltas:
                        if d.kind == _dl.NODE_JOIN:
                            names.add(d.node_name)
                        elif d.kind == _dl.NODE_DRAIN:
                            if d.node_name not in names:
                                raise InputError(
                                    "node_drain delta names unknown "
                                    f"node {d.node_name!r}"
                                )
                            names.discard(d.node_name)
                        elif d.kind in (_dl.POD_BIND, _dl.POD_ARRIVE):
                            _wl.pod_from_pod(_copy.deepcopy(d.pod))
                except (UnicodeDecodeError, ValueError, InputError) as e:
                    self._send(
                        400,
                        json.dumps(
                            {"error": str(e), "requestId": rid}
                        ).encode(),
                        headers=(rid_header,),
                    )
                    return
                if daemon._shutdown.is_set():
                    from .coalescer import partial_body

                    self._send(
                        503,
                        partial_body(
                            "drain", "daemon is draining", request_id=rid
                        ),
                        headers=(rid_header,),
                    )
                    return
                counts = {"applied": 0, "skipped": 0, "reloads": 0}
                try:
                    for d, rec in zip(deltas, recs):
                        out, seq = daemon.session.apply_delta_seq(d)
                        daemon.sessions.record_delta(
                            daemon.session.fingerprint,
                            rec,
                            request_id=rid,
                            seq=seq,
                        )
                        if daemon.checkpoints is not None:
                            daemon.checkpoints.note_delta(seq)
                        if out == "skipped":
                            counts["skipped"] += 1
                        else:
                            counts["applied"] += 1
                            if out == "reloaded":
                                counts["reloads"] += 1
                except InputError as e:
                    # mid-stream application error (e.g. a drain naming
                    # an unknown node): report what landed — the
                    # journal holds the applied prefix
                    self._send(
                        409,
                        json.dumps(
                            {
                                "error": str(e),
                                **counts,
                                "deltaSeq": daemon.session.delta_seq,
                                "requestId": rid,
                            }
                        ).encode(),
                        headers=(rid_header,),
                    )
                    return
                self._send(
                    200,
                    json.dumps(
                        {**counts, "deltaSeq": daemon.session.delta_seq}
                    ).encode(),
                    headers=(rid_header,),
                )

            def _do_simulate(self):
                # request correlation end-to-end (obs/telemetry.py):
                # the caller's X-Simon-Request-Id (else a minted one)
                # is bound for the whole handler scope — every span
                # recorded while THIS request is parsed/admitted/
                # answered carries it — echoed on every response
                # (200/400/429/503/500) and carried in every shed/
                # PARTIAL body. The 200 body itself stays byte-
                # identical to standalone simulate() (the coalescing
                # conformance contract): correlation lives in headers
                # and error/shed bodies only.
                rid = telemetry.ensure_request_id(
                    self.headers.get(telemetry.REQUEST_ID_HEADER)
                )
                with telemetry.request_scope(rid):
                    self._do_simulate_correlated(rid)

            def _do_simulate_correlated(self, rid: str):
                from ..obs.spans import RECORDER

                rid_header = (telemetry.REQUEST_ID_HEADER, rid)
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                try:
                    req, deadline, want_trace = parse_request_body(
                        raw, self.headers.get("Content-Type", "")
                    )
                except ValueError as e:
                    self._send(
                        400,
                        json.dumps(
                            {"error": str(e), "requestId": rid}
                        ).encode(),
                        headers=(rid_header,),
                    )
                    return
                if deadline is None:
                    deadline = daemon.default_deadline_s
                from .coalescer import partial_body

                header_tenant = self.headers.get("X-Simon-Tenant")
                tenant = (
                    sanitize_tenant(header_tenant)
                    if header_tenant
                    else req.tenant
                )
                COUNTERS.inc(f"serve_tenant_requests:{tenant}")
                # cost-predictive admission BEFORE the queue: 429 when
                # the predicted wait busts the tick budget, serial
                # routing when the predicted device memory would not fit
                with RECORDER.span("serve/request/admission"):
                    verdict = daemon.admission.decide(
                        est_pods=estimate_request_pods(req),
                        queue_depth=daemon.coalescer.depth,
                    )
                if verdict.action == "shed":
                    # serve_admission_shed_total counted by decide()
                    COUNTERS.inc("serve_shed_total")
                    COUNTERS.inc(f"serve_tenant_shed:{tenant}")
                    self._send(
                        429,
                        partial_body(
                            "admission", verdict.reason, request_id=rid
                        ),
                        headers=(
                            ("Retry-After", str(verdict.retry_after_s)),
                            rid_header,
                        ),
                    )
                    return
                # cross-process trace context (fleet router hop): a
                # malformed header degrades to (None, 0), never a 4xx
                trace_parent, trace_hop = telemetry.parse_trace_context(
                    self.headers.get(telemetry.TRACE_CONTEXT_HEADER)
                )
                pending = PendingRequest(
                    request=req,
                    budget=Budget(deadline),
                    route="serial" if verdict.action == "serial" else "batch",
                    tenant=tenant,
                    route_reason=verdict.reason,
                    request_id=rid,
                    trace_parent=trace_parent,
                    trace_hop=trace_hop,
                )
                if not daemon.coalescer.submit(pending):
                    draining = daemon._shutdown.is_set()
                    COUNTERS.inc(f"serve_tenant_shed:{tenant}")
                    self._send(
                        503,
                        partial_body(
                            "drain" if draining else "overload",
                            "daemon is draining for shutdown"
                            if draining
                            else f"queue full at depth {daemon.coalescer.queue_depth}",
                            request_id=rid,
                        ),
                        headers=(
                            ("Retry-After", str(daemon.coalescer.retry_after_s())),
                            rid_header,
                        ),
                    )
                    return
                wait = (deadline or 0) + _RESULT_WAIT_SLACK_S
                if not pending.done.wait(timeout=wait):
                    self._send(
                        500,
                        json.dumps(
                            {
                                "error": "dispatcher unresponsive",
                                "requestId": rid,
                            }
                        ).encode(),
                        headers=(rid_header,),
                    )
                    return
                reply = pending.reply
                headers = [
                    ("X-Simon-Engine", str(reply.meta.get("engine", ""))),
                    ("X-Simon-Batch-Size", str(reply.meta.get("batchSize", ""))),
                    rid_header,
                ]
                if reply.meta.get("incremental"):
                    # diagnostic only: the body is byte-identical to the
                    # full path; this names the suffix-dispatch route
                    headers.append(
                        ("X-Simon-Incremental", str(reply.meta["incremental"]))
                    )
                if want_trace:
                    headers.append(
                        ("X-Simon-Trace", json.dumps(reply.meta, sort_keys=True))
                    )
                with RECORDER.span("serve/request/reply"):
                    self._send(reply.status, reply.body, headers=headers)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._server_thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="simon-serve-http",
            daemon=True,
        )

    def start(self):
        self.telemetry.start()
        self.coalescer.start()
        if self.checkpoints is not None:
            self.checkpoints.start()
        self._server_thread.start()
        log.info("simon serve listening on %s:%d", self.host, self.port)

    def readiness(self):
        """-> (status, reasons): "ok" or "degraded" with one reason
        per degradation the daemon is living with — an open circuit
        breaker, a dispatcher the watchdog had to restart, or the
        device-memory ledger past its budget. Liveness stays "ok":
        true either way (the process IS up); readiness-aware clients
        route on ``status`` (docs/SERVING.md)."""
        from ..obs.ledger import device_memory_stats
        from ..runtime.retry import breaker_states

        reasons = []
        for endpoint, st in sorted(breaker_states().items()):
            if st["open"]:
                reasons.append(f"circuit breaker open: {endpoint}")
        if self.coalescer.restarts:
            reasons.append(
                f"dispatcher watchdog fired {self.coalescer.restarts} "
                "time(s) this process"
            )
        in_use, _peak, limit, _src = device_memory_stats()
        if limit and in_use > limit:
            reasons.append(
                f"device memory over budget ({in_use} > {limit} bytes)"
            )
        if self.slo_engine is not None:
            reasons.extend(self.slo_engine.reasons())
        if self.checkpoints is not None:
            reasons.extend(self.checkpoints.degraded_reasons())
        return ("degraded" if reasons else "ok"), reasons

    def begin_shutdown(self):
        """Stop intake (new submits shed as draining); idempotent."""
        self._shutdown.set()
        self.coalescer.close()

    def shutdown(self) -> int:
        """Drain and stop. Returns the process exit code: 0 when every
        queued request was answered within --drain-timeout, 3 (the
        deadline-partial code) when leftovers had to be shed."""
        self.begin_shutdown()  # also closes coalescer intake
        drained = self.coalescer.drain(timeout=self.drain_timeout_s)
        # the coalescer answered every request; now wait for the
        # handler threads to finish WRITING those answers (bounded: a
        # wedged client socket must not hold the exit hostage)
        self._inflight_zero.wait(timeout=min(self.drain_timeout_s, 10.0))
        if self.checkpoints is not None:
            # the worker must not race the journal close below (drain
            # appends, then closes the snapshot the compactor rewrites)
            self.checkpoints.stop()
        self.sessions.drain()  # journal surviving warm sessions
        self.telemetry.stop()  # one final sample so dumps see the end
        self.httpd.shutdown()
        self.httpd.server_close()
        if not drained:
            log.warning(
                "drain timeout (%.1fs) expired with requests still queued; shed",
                self.drain_timeout_s,
            )
        return EXIT_OK if drained else EXIT_PARTIAL_DEADLINE

    def run_until_signaled(self) -> int:
        """Block until SIGTERM/SIGINT, then drain and return the exit
        code. Installs handlers (main thread only)."""

        def handler(signum, frame):
            log.info("received signal %d: draining", signum)
            self.begin_shutdown()
            self._wake.set()

        self._wake = threading.Event()
        prev_term = signal.signal(signal.SIGTERM, handler)
        prev_int = signal.signal(signal.SIGINT, handler)
        try:
            # a timed wait: a signal the kernel hands to another thread
            # only sets Python's flag and leaves a main thread blocked in
            # an untimed wait asleep, so it wakes to run the handler
            while not self._wake.wait(timeout=0.5):
                pass
            return self.shutdown()
        finally:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)
