"""`simon twin` — the live digital-twin daemon (the port's copy of the
JAX package's twin/server.py: the same endpoints, status codes, bodies
and ``Retry-After`` rules).

One resident process per cluster: a tail thread keeps the mirror
current (twin/mirror.py) while HTTP handlers answer operational
questions against it (twin/queries.py), behind the same cost-predictive
admission control `simon serve` runs (serve/admission.py).

JSON-over-HTTP API (docs/TWIN.md):

- ``POST /v1/whatif`` — body is the serve envelope
  (``{"apps": [{"name":..., "yaml":"..."}]}`` or raw YAML): would
  these apps fit right now?
- ``POST /v1/drain`` — ``{"nodes": [...]}`` and/or
  ``{"selector": {"rack": "r7"}}``: can I cordon these nodes now?
- ``POST /v1/nplusk`` — ``{"k": 1, "trials": 32, "seed": 1}``: does
  the live placement survive any K-node outage?
- ``POST /v1/forecast`` — ``{"horizonSeconds": 3600,
  "rateScale": 2.0, ...}``: timeline windows stepped forward from the
  current mirrored state.
- ``GET /healthz`` — liveness + readiness (mirror staleness, apply
  errors, open breakers) + mirror stats.
- ``GET /metrics`` — Prometheus text: agreement-rate, mirror-lag and
  backlog gauges (the alertable pair), delta/divergence/flap
  counters, query latency histograms, plus the full resilience and
  observatory expositions serve exports.

Lifecycle: SIGTERM/SIGINT stops the tail, waits for in-flight queries
to finish writing, and exits 0.

``/metrics`` counts the port's own work where the JAX daemon counts
the compiler's: launches per site, nvcc builds and cache hits, and the
warm builds of the mirror's probes (``simon_shadow_warm_builds_total``,
nvcc builds on an already-seen probe shape: 0 once the kernel library
is loaded) in place of ``simon_shadow_warm_recompiles_total``.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..models.validation import InputError
from ..obs import profile, telemetry
from ..runtime.errors import GuardError
from ..serve.admission import AdmissionController, estimate_request_pods
from ..utils.trace import COUNTERS
from . import queries

log = logging.getLogger(__name__)

QUERY_HISTO = "twin/query"


class TwinAdmission(AdmissionController):
    """Serve's cost-predictive admission pointed at the twin's own
    latency histogram: shed with Retry-After when the p95 query time
    times the queue ahead busts the budget. (The device-memory verdict
    stays on the cost records of the scan site the queries launch.)"""

    def _predicted_tick_s(self) -> float:
        from ..obs.histo import HISTOS

        h = HISTOS.peek(QUERY_HISTO)
        if h is None:
            return 0.0
        return float(h.percentile(95.0))


def render_twin_metrics(daemon: "TwinDaemon") -> bytes:
    """Prometheus exposition: the twin block first, then the shadow
    divergence counters the mirror's replayer feeds, then the shared
    resilience + observatory blocks (serve/server.py helpers — one
    exposition dialect across both daemons)."""
    from ..serve.server import (
        _observatory_lines,
        _resilience_lines,
        _telemetry_lines,
    )

    snap = COUNTERS.snapshot()
    counts, gauges = snap["counts"], snap["gauges"]
    lines = []

    def metric(name, kind, help_text, value):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    stats = daemon.mirror.stats()
    metric(
        "simon_twin_agreement_rate", "gauge",
        "Agreement rate of the mirror's divergence audit (1.0 = the real "
        "scheduler and simon fully agree).",
        gauges.get("twin_agreement_rate", 1.0),
    )
    metric(
        "simon_twin_mirror_lag_seconds", "gauge",
        "Age of the oldest observed-but-unapplied step (mirror staleness).",
        gauges.get("twin_mirror_lag_seconds", 0.0),
    )
    metric(
        "simon_twin_backlog", "gauge",
        "Observed steps waiting for bounded catch-up.",
        gauges.get("twin_backlog", 0.0),
    )
    metric(
        "simon_twin_pending_pods", "gauge",
        "Pods the real scheduler has not placed (the forecast requeue set).",
        stats["pendingPods"],
    )
    metric(
        "simon_twin_nodes", "gauge",
        "Nodes currently mirrored.", stats["nodes"],
    )
    for key, help_text in (
        ("twin_polls_total", "Tail polls attempted (flaps included)."),
        ("twin_tail_flaps_total", "Polls that failed and backed off."),
        ("twin_tail_deferred_steps_total", "Steps deferred past a bounded catch-up round."),
        ("twin_deltas_applied_total", "Cluster deltas applied to the warm mirror."),
        ("twin_delta_reloads_total", "Deltas that forced a state rebuild (node_drain only)."),
        ("twin_delta_skips_total", "Deltas skipped on live-tail races (counted, never fatal)."),
        ("twin_apply_errors_total", "Steps the substrate could not apply (mirror degraded)."),
        ("twin_whatif_total", "What-if queries answered."),
        ("twin_drain_total", "Drain-safety queries answered."),
        ("twin_nplusk_total", "N+K survivability queries answered."),
        ("twin_forecast_total", "Capacity forecasts answered."),
        ("twin_query_dispatches_total", "Warm scans (one launch each on the cuda engine) spent on queries."),
        ("twin_queries_shed_total", "Queries shed 429 by admission."),
    ):
        # twin_polls_total is derived from the gauge (poll_once counts
        # polls on the mirror, exported as a gauge)
        value = (
            int(gauges.get("twin_polls", 0.0))
            if key == "twin_polls_total"
            else counts.get(key, 0)
        )
        metric(f"simon_{key}", "counter", help_text, value)
    # the shadow divergence vocabulary (the mirror IS a shadow replay)
    for key, help_text in (
        ("shadow_steps_total", "Mirror steps applied (decisions + deltas)."),
        ("shadow_decisions_total", "Real scheduler decisions mirrored."),
        ("shadow_agree_total", "Decisions simon agreed with."),
        ("shadow_divergence_total", "Decisions simon diverged on."),
        ("shadow_warm_builds_total", "nvcc builds on an already-seen mirror probe shape."),
        ("shadow_ingest_event_decisions_total", "Tail decisions sourced from scheduler Event objects."),
        ("shadow_ingest_diff_decisions_total", "Tail decisions inferred from pod diffs alone."),
    ):
        metric(f"simon_{key}", "counter", help_text, counts.get(key, 0))
    # the port's launches and kernel builds (obs/profile.py,
    # utils/nvcc.py), where the JAX daemon counts recompiles
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
    lines.append(
        "# HELP simon_launches_site_total Instrumented launches per site."
    )
    lines.append("# TYPE simon_launches_site_total counter")
    for site in sorted(
        k[len("launches_"):] for k in counts
        if k.startswith("launches_") and k != "launches_total"
    ):
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
    # NOTE: _observatory_lines already includes the histogram
    # exposition; appending histo.prometheus_lines() again here used to
    # emit every latency family twice — duplicate samples a Prometheus
    # scraper rejects (caught by the exposition conformance test)
    lines.extend(_resilience_lines(snap))
    lines.extend(_observatory_lines(snap))
    lines.extend(_telemetry_lines(snap, daemon.slo_engine))
    lines.append("")
    return "\n".join(lines).encode()


def parse_whatif_body(raw: bytes, content_type: str):
    """The serve request dialect reused verbatim: the answer to 'would
    this deployment fit' must not depend on which daemon you asked."""
    from ..serve.server import parse_request_body

    req, _deadline, _trace = parse_request_body(raw, content_type)
    return req


def _parse_json_object(raw: bytes) -> dict:
    try:
        doc = json.loads(raw.decode("utf-8")) if raw.strip() else {}
    except (UnicodeDecodeError, ValueError) as e:
        raise InputError(f"body is not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise InputError("body must be a JSON object")
    return doc


def canonical_body(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


class TwinDaemon:
    """Owns the HTTP server, the tail thread, and the drain
    lifecycle."""

    def __init__(
        self,
        mirror,
        host: str = "127.0.0.1",
        port: int = 8080,
        poll_interval_s: float = 2.0,
        max_polls: Optional[int] = None,
        tick_budget_s: Optional[float] = None,
        max_request_pods: Optional[int] = None,
        drain_timeout_s: float = 30.0,
        budget=None,
        slo_engine=None,
        obs_cadence_s: float = 1.0,
        snapshot_path: Optional[str] = None,
        checkpoint_interval: Optional[int] = None,
        keep_checkpoints: int = 2,
    ):
        if poll_interval_s <= 0:
            raise InputError(
                f"--poll-interval must be > 0s, got {poll_interval_s}"
            )
        self.mirror = mirror
        self.poll_interval_s = poll_interval_s
        self.max_polls = max_polls
        self.drain_timeout_s = drain_timeout_s
        self.budget = budget
        self.slo_engine = slo_engine
        self.telemetry = telemetry.TelemetryRuntime(
            cadence_s=obs_cadence_s, slo_engine=slo_engine
        )
        self.admission = TwinAdmission(
            max_batch=1,
            tick_budget_s=tick_budget_s,
            max_request_pods=max_request_pods,
        )
        # bounded-recovery checkpoints (runtime/checkpoint.py): the
        # same ladder serve runs — verified mirror snapshots every
        # --checkpoint-interval applied steps, journal compacted to
        # the unabsorbed suffix (the mirror's journal was attached by
        # the CLI before this daemon was built)
        self.checkpoints = None
        if snapshot_path and checkpoint_interval:
            from ..runtime.checkpoint import CheckpointManager, checkpoint_dir
            from .mirror import (
                capture_mirror,
                twin_keep_record,
                twin_materialized_digest,
            )

            self.checkpoints = CheckpointManager(
                checkpoint_dir(snapshot_path),
                interval=checkpoint_interval,
                keep=keep_checkpoints,
                capture=lambda: capture_mirror(self.mirror),
                materialized_digest=twin_materialized_digest,
                journal=mirror.journal,
                keep_record=twin_keep_record,
                label="twin",
            )
        self._stop = threading.Event()
        self._tail_done = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._inflight_zero = threading.Event()
        self._inflight_zero.set()
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s %s", self.address_string(), fmt % args)

            def _send(self, status: int, body: bytes,
                      content_type="application/json", headers=()):
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
                    # hint as the admission 429 path (p95 query time x
                    # queries in flight), so probers and LBs back off
                    # uniformly with shed clients
                    hdrs = ()
                    retry_after = None
                    if reasons:
                        with daemon._inflight_lock:
                            waiting = max(daemon._inflight, 0)
                        retry_after = daemon.admission.retry_after_hint(
                            waiting
                        )
                        hdrs = (("Retry-After", str(retry_after)),)
                    self._send(200, canonical_body({
                        "ok": True,
                        "status": status,
                        "degraded": bool(reasons),
                        "reasons": reasons,
                        "retryAfterSeconds": retry_after,
                        "sloAlerting": (
                            daemon.slo_engine.alerting()
                            if daemon.slo_engine is not None
                            else []
                        ),
                        # serve-parity identity (docs/FLEET.md): the
                        # fields fleet-style supervision of twin
                        # replicas verifies restore identity against
                        "cluster": daemon.mirror.replayer.report.fingerprint,
                        "deltaSeq": daemon.mirror.applied_seq(),
                        "checkpoint": (
                            daemon.checkpoints.stats()
                            if daemon.checkpoints is not None
                            else None
                        ),
                        "mirror": daemon.mirror.stats(),
                    }), headers=hdrs)
                elif self.path == "/v1/state-digest":
                    # the same dict-identity triple serve exposes: a
                    # replacement twin is correct iff this matches the
                    # mirror it replaced
                    self._send(200, canonical_body({
                        "fingerprint": daemon.mirror.replayer.report.fingerprint,
                        "deltaSeq": daemon.mirror.applied_seq(),
                        "stateDigest": daemon.mirror.state_digest(),
                    }))
                elif self.path == "/metrics":
                    self._send(
                        200,
                        render_twin_metrics(daemon),
                        content_type="text/plain; version=0.0.4",
                    )
                elif self.path.startswith("/v1/obs/series"):
                    status, doc = telemetry.series_endpoint(self.path)
                    self._send(status, canonical_body(doc))
                elif self.path == "/v1/obs/snapshot":
                    self._send(
                        200,
                        canonical_body(
                            telemetry.snapshot_doc(
                                daemon.slo_engine,
                                runtime=daemon.telemetry,
                                extra={
                                    "daemon": "twin",
                                    "health": daemon.readiness()[0],
                                },
                            )
                        ),
                    )
                else:
                    self._send(404, json.dumps({"error": "not found"}).encode())

            def do_POST(self):
                if self.path == "/debug/dump":
                    length = int(self.headers.get("Content-Length") or 0)
                    status, doc = telemetry.handle_debug_dump(
                        self.rfile.read(length),
                        slo_engine=daemon.slo_engine,
                        runtime=daemon.telemetry,
                        label="twin",
                    )
                    self._send(status, canonical_body(doc))
                    return
                route = {
                    "/v1/whatif": daemon._q_whatif,
                    "/v1/drain": daemon._q_drain,
                    "/v1/nplusk": daemon._q_nplusk,
                    "/v1/forecast": daemon._q_forecast,
                }.get(self.path)
                if route is None:
                    self._send(404, json.dumps({"error": "not found"}).encode())
                    return
                with daemon._inflight_lock:
                    daemon._inflight += 1
                    daemon._inflight_zero.clear()
                try:
                    self._route(route)
                finally:
                    with daemon._inflight_lock:
                        daemon._inflight -= 1
                        if daemon._inflight == 0:
                            daemon._inflight_zero.set()

            def _route(self, route):
                # the serve request-ID contract verbatim: accepted or
                # minted, bound for the query's whole scope (mirror
                # probes and scan spans all stamp it), echoed on every
                # response
                rid = telemetry.ensure_request_id(
                    self.headers.get(telemetry.REQUEST_ID_HEADER)
                )
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                with telemetry.request_scope(rid):
                    status, payload, headers = daemon.answer(
                        route,
                        raw,
                        self.headers.get("Content-Type", ""),
                        rid=rid,
                    )
                headers = tuple(headers) + (
                    (telemetry.REQUEST_ID_HEADER, rid),
                )
                self._send(status, payload, headers=headers)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._server_thread = threading.Thread(
            target=self.httpd.serve_forever, name="simon-twin-http", daemon=True
        )
        self._tail_thread = threading.Thread(
            target=self._tail_loop, name="simon-twin-tail", daemon=True
        )

    # -- query dispatch -----------------------------------------------------

    def answer(self, route, raw: bytes, content_type: str, rid: str = ""):
        """One admission-gated query evaluation. Returns
        (status, body bytes, headers). ``rid`` is the request's
        correlation ID — carried in every error/shed body (the 200
        body stays a pure function of the query, echoed in the
        response header by the handler instead)."""
        from ..obs.histo import HISTOS
        from ..obs.spans import RECORDER

        def err_body(doc: dict) -> bytes:
            if rid:
                doc = {**doc, "requestId": rid}
            return canonical_body(doc)

        try:
            est_pods, call = route(raw, content_type)
        except (InputError, ValueError) as e:
            return 400, err_body({"error": str(e)}), ()
        with self._inflight_lock:
            waiting = self._inflight - 1  # queries ahead of this one
        verdict = self.admission.decide(
            est_pods=est_pods, queue_depth=max(waiting, 0)
        )
        if verdict.action == "shed":
            COUNTERS.inc("twin_queries_shed_total")
            return (
                429,
                err_body({"error": verdict.reason, "shed": True}),
                (("Retry-After", str(verdict.retry_after_s)),),
            )
        t0 = time.perf_counter()
        try:
            with RECORDER.span("twin/request"):
                try:
                    out = call()
                finally:
                    # the query's launch times, read on the handler
                    # thread that launched them (obs/profile.py)
                    profile.resolve_pending(wait=True)
        except (InputError, ValueError) as e:
            return 400, err_body({"error": str(e)}), ()
        except GuardError as e:
            # classified degradation (device OOM mid-query, injected
            # fault): a typed 500, the daemon stays up
            COUNTERS.inc("twin_query_errors_total")
            return (
                500,
                err_body({"error": str(e), "type": type(e).__name__}),
                (),
            )
        HISTOS.observe(QUERY_HISTO, time.perf_counter() - t0)
        return 200, canonical_body(out), ()

    def _q_whatif(self, raw, content_type):
        req = parse_whatif_body(raw, content_type)
        return (
            estimate_request_pods(req),
            lambda: queries.whatif(self.mirror, req.apps),
        )

    def _q_drain(self, raw, content_type):
        doc = _parse_json_object(raw)
        nodes = doc.get("nodes") or ()
        selector = doc.get("selector")
        if not isinstance(nodes, (list, tuple)):
            raise InputError('"nodes" must be a list of node names')
        return (
            0,
            lambda: queries.drain(self.mirror, nodes=nodes, selector=selector),
        )

    def _q_nplusk(self, raw, content_type):
        doc = _parse_json_object(raw)
        return (
            0,
            lambda: queries.nplusk(
                self.mirror,
                k=int(doc.get("k", 1)),
                trials=int(doc.get("trials", 32)),
                seed=int(doc.get("seed", 1)),
            ),
        )

    def _q_forecast(self, raw, content_type):
        doc = _parse_json_object(raw)
        horizon = doc.get("horizonSeconds")
        if horizon is None:
            raise InputError('forecast needs "horizonSeconds"')
        rate = doc.get("arrivalRate")
        return (
            0,
            lambda: queries.forecast(
                self.mirror,
                horizon_s=float(horizon),
                arrival_rate=None if rate is None else float(rate),
                rate_scale=float(doc.get("rateScale", 1.0)),
                seed=int(doc.get("seed", 1)),
                policy=str(doc.get("policy", "static:0")),
                cadence_s=float(doc.get("cadenceSeconds", 60.0)),
                warmup_s=float(doc.get("warmupSeconds", 0.0)),
                max_nodes=int(doc.get("maxNodes", 0)),
                # the mirror's engine and device unless the query
                # names one (the JAX daemon defaults to the oracle)
                engine=None if doc.get("engine") is None else str(doc["engine"]),
                mean_lifetime_s=float(doc.get("meanLifetimeSeconds", 600.0)),
            ),
        )

    # -- the tail loop ------------------------------------------------------

    def _tail_loop(self):
        from ..runtime.errors import ExecutionHalted
        from ..runtime.retry import backoff_delay

        flaps = 0
        polls = 0
        try:
            while not self._stop.is_set():
                if self.budget is not None:
                    self.budget.check(f"twin tail (poll {polls})")
                if self.max_polls is not None and polls >= self.max_polls:
                    # the mirror stays queryable at its final state —
                    # which must include every OBSERVED step, not just
                    # the caught-up prefix
                    self.mirror.drain_backlog(budget=self.budget)
                    break
                if getattr(self.mirror.source, "exhausted", False):
                    # recorded feeds run dry; the mirror stays
                    # queryable at its final state until signaled
                    self.mirror.drain_backlog(budget=self.budget)
                    if self.checkpoints is not None:
                        self.checkpoints.note_delta(self.mirror.applied_seq())
                    break
                applied = self.mirror.poll_once(budget=self.budget)
                # the probes' launch times, read on the tail thread
                profile.resolve_pending(wait=True)
                polls += 1
                if applied > 0 and self.checkpoints is not None:
                    self.checkpoints.note_delta(self.mirror.applied_seq())
                if applied < 0:
                    flaps += 1
                    delay = min(
                        backoff_delay("twin-tail", min(flaps, 6)),
                        self.poll_interval_s,
                    )
                else:
                    flaps = 0
                    delay = self.poll_interval_s
                self._stop.wait(timeout=delay)
        except ExecutionHalted:
            log.warning("twin tail halted by deadline; mirror frozen")
        finally:
            self._tail_done.set()

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self.telemetry.start()
        if self.checkpoints is not None:
            self.checkpoints.start()
        self._server_thread.start()
        self._tail_thread.start()
        log.info("simon twin listening on %s:%d", self.host, self.port)

    def readiness(self):
        from ..runtime.retry import breaker_states

        reasons = list(self.mirror.degraded_reasons())
        for endpoint, st in sorted(breaker_states().items()):
            if st["open"]:
                reasons.append(f"circuit breaker open: {endpoint}")
        if self.slo_engine is not None:
            reasons.extend(self.slo_engine.reasons())
        if self.checkpoints is not None:
            reasons.extend(self.checkpoints.degraded_reasons())
        return ("degraded" if reasons else "ok"), reasons

    def begin_shutdown(self):
        self._stop.set()

    def shutdown(self) -> int:
        self.begin_shutdown()
        self._tail_done.wait(timeout=self.drain_timeout_s)
        self._inflight_zero.wait(timeout=min(self.drain_timeout_s, 10.0))
        if self.checkpoints is not None:
            # stop the worker before the journal closes underneath it
            self.checkpoints.stop()
        if self.mirror.journal is not None:
            self.mirror.journal.close()
        self.telemetry.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        return 0

    def run_until_signaled(self) -> int:
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
