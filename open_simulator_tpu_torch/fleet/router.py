"""The fleet router daemon behind ``simon fleet`` (the port's copy of
the JAX package's fleet/router.py: the same routing, statuses, bodies,
headers and exposition, with the port's counters re-exported).

A thin HTTP reverse proxy in front of N serve replicas. Design
posture: the router holds NO session state — replicas own sessions,
journals, the card and the kernel libraries; the router owns only the
ring, the health table, and the supervision loop — so the router
itself is trivially restartable, does no device work, and is never on
a replica's build path.

- **Tenant-affine routing**: the routing key is the request's
  ``X-Simon-Cluster`` header (a cluster fingerprint) when present,
  else its tenant (``X-Simon-Tenant`` header or JSON ``tenant`` key),
  consistent-hashed over the slot ring (fleet/hashing.py). One
  tenant's warm session, committed scan, and delta journal live on
  ONE replica and stay there.
- **Failover, never silent drops**: the request body is buffered
  before forwarding, so a replica that dies mid-request is retried
  against the next slot in ``route_order`` with the ORIGINAL
  X-Simon-Request-Id. Replica answers — including 429/503 with their
  Retry-After — pass through verbatim plus an ``X-Simon-Fleet-
  Replica`` header naming the slot that answered. When no replica can
  answer, the router sheds with 503 + Retry-After and the request id
  in the body (the PR-11 shed contract), never a dropped connection.
- **Supervision**: a background loop probes each replica's /healthz
  through the ``fleet.probe`` seam, honors a degraded replica's
  Retry-After hint (backs off probing instead of hot-looping), and
  declares a replica dead after PROBE_FAILURE_THRESHOLD consecutive
  failures OR process exit — then respawns it into the same slot with
  capped-exponential backoff. The replacement resumes the slot's
  snapshot journal and replays its delta stream (fleet/replay.py), so
  it rejoins dict-identical and, from the shared kernel-library
  store, without an nvcc build.
- **Aggregated observability**: /metrics emits the router's own
  ``simon_fleet_*`` counters plus a cardinality-bounded allowlist of
  per-replica families scraped from each live replica and re-labeled
  ``{replica="<slot>"}`` (bounded: |allowlist| x N series, no tenant
  or request labels cross the aggregation). /healthz aggregates fleet
  readiness with the per-replica table; /v1/obs/snapshot feeds
  ``simon top``.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..models.validation import InputError
from ..obs import telemetry
from ..obs.histo import HISTOS
from ..obs.spans import RECORDER
from ..runtime import inject as _inject
from ..runtime.errors import EXIT_OK, EXIT_PARTIAL_DEADLINE, GuardError
from ..utils.trace import COUNTERS
from .hashing import HashRing
from .replica import PROBE_FAILURE_THRESHOLD

log = logging.getLogger("simon.fleet")

#: per-replica metric families re-exported by the fleet /metrics
#: aggregation. An ALLOWLIST, not a passthrough: fleet cardinality is
#: bounded at |this list| x N replicas regardless of what a replica
#: exposes (per-tenant and per-site families deliberately excluded).
#: The port's serve counts its own work (serve/server.py): nvcc builds
#: and kernel launches stand where the JAX package re-exports its
#: recompiles and dispatches.
REPLICA_METRIC_ALLOWLIST = (
    "simon_serve_requests_total",
    "simon_serve_shed_total",
    "simon_serve_queue_depth",
    "simon_serve_batches_total",
    "simon_nvcc_builds_total",
    "simon_launches_total",
    "simon_aot_store_hit_total",
    "simon_aot_store_save_total",
)

#: how long scraped replica metrics stay fresh before /metrics
#: re-scrapes (bounds scrape amplification: one fleet scrape costs at
#: most N replica scrapes per TTL window)
SCRAPE_TTL_S = 2.0

#: hop-by-hop headers never forwarded in either direction
_HOP_HEADERS = {
    "connection",
    "keep-alive",
    "transfer-encoding",
    "host",
    "content-length",
}


def _shed_body(reason: str, message: str, request_id: str) -> bytes:
    """The router's 503 shed body — same shape as the coalescer's
    partial_body so clients parse one schema fleet-wide."""
    return json.dumps(
        {
            "success": False,
            "partial": True,
            "reason": reason,
            "error": message,
            "requestId": request_id,
        },
        sort_keys=True,
    ).encode()


class FleetRouter:
    """Owns the ring, the replica table, the probe/respawn loop, and
    the proxy HTTP server."""

    def __init__(
        self,
        replicas: List,
        host: str = "127.0.0.1",
        port: int = 0,
        probe_interval_s: float = 2.0,
        drain_timeout_s: float = 30.0,
        forward_timeout_s: float = 120.0,
        slo_engine=None,
        obs_cadence_s: float = 1.0,
        supervise: bool = True,
        spawn_attempts: int = 4,
        audit=None,
    ):
        if not replicas:
            raise InputError("a fleet needs at least one replica")
        # failover audit timeline (fleet/audit.py) — optional: probe
        # flaps, death declarations, respawns, and the first 200 after
        # a failover are appended as fsync'd JSONL events
        self.audit = audit
        self.replicas = {r.slot: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise InputError("replica slots must be unique")
        self.ring = HashRing(sorted(self.replicas))
        self.probe_interval_s = probe_interval_s
        self.drain_timeout_s = drain_timeout_s
        self.forward_timeout_s = forward_timeout_s
        self.slo_engine = slo_engine
        self.supervise = supervise
        self.spawn_attempts = spawn_attempts
        self.telemetry = telemetry.TelemetryRuntime(
            cadence_s=obs_cadence_s, slo_engine=slo_engine
        )
        # health table: slot -> "up" | "degraded" | "down"; routing
        # consults it, the probe loop maintains it. A slot marked
        # down by a failed FORWARD is rerouted immediately — the
        # probe loop confirms and respawns asynchronously.
        self._health: Dict[str, str] = {s: "up" for s in self.replicas}
        self._health_lock = threading.Lock()
        self._next_probe: Dict[str, float] = {s: 0.0 for s in self.replicas}
        self._scrape_cache: Dict[str, tuple] = {}  # slot -> (t, text)
        self._shutdown = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s %s", self.address_string(), fmt % args)

            def _send(self, status, body, content_type="application/json", headers=()):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    status, reasons, table = router.readiness()
                    hdrs = ()
                    if reasons:
                        hdrs = (("Retry-After", str(router.retry_after_s())),)
                    self._send(
                        200,
                        json.dumps(
                            {
                                "ok": True,
                                "status": status,
                                "degraded": bool(reasons),
                                "reasons": reasons,
                                "replicas": table,
                                "sloAlerting": (
                                    router.slo_engine.alerting()
                                    if router.slo_engine is not None
                                    else []
                                ),
                                "draining": router._shutdown.is_set(),
                            },
                            sort_keys=True,
                        ).encode(),
                        headers=hdrs,
                    )
                elif self.path == "/metrics":
                    self._send(
                        200,
                        render_fleet_metrics(router),
                        content_type="text/plain; version=0.0.4",
                    )
                elif self.path.startswith("/v1/obs/series"):
                    status, doc = telemetry.series_endpoint(self.path)
                    self._send(status, json.dumps(doc, sort_keys=True).encode())
                elif self.path.startswith("/v1/fleet/trace"):
                    from .trace import trace_endpoint

                    status, doc = trace_endpoint(router, self.path)
                    self._send(status, json.dumps(doc, sort_keys=True).encode())
                elif self.path == "/v1/obs/snapshot":
                    self._send(
                        200,
                        json.dumps(
                            telemetry.snapshot_doc(
                                router.slo_engine,
                                runtime=router.telemetry,
                                extra={
                                    "daemon": "fleet",
                                    "health": router.readiness()[0],
                                    "replicas": {
                                        s: router._health.get(s, "down")
                                        for s in router.replicas
                                    },
                                },
                            ),
                            sort_keys=True,
                        ).encode(),
                    )
                else:
                    self._proxy("GET")

            def do_POST(self):
                if self.path == "/debug/dump":
                    length = int(self.headers.get("Content-Length") or 0)
                    status, doc = telemetry.handle_debug_dump(
                        self.rfile.read(length),
                        slo_engine=router.slo_engine,
                        runtime=router.telemetry,
                        label="fleet",
                    )
                    self._send(status, json.dumps(doc, sort_keys=True).encode())
                    return
                self._proxy("POST")

            def _proxy(self, method: str):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                rid = telemetry.ensure_request_id(
                    self.headers.get(telemetry.REQUEST_ID_HEADER)
                )
                status, resp_body, headers = router.route_and_forward(
                    method, self.path, body, dict(self.headers.items()), rid
                )
                self._send(status, resp_body, headers=headers)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._server_thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="simon-fleet-http",
            daemon=True,
        )

    # -- routing -------------------------------------------------------------

    @staticmethod
    def routing_key(headers: Dict[str, str], body: bytes) -> str:
        """Cluster fingerprint when the client names one, else the
        tenant — the affinity key that keeps one tenant's warm state
        on one replica."""
        lower = {k.lower(): v for k, v in headers.items()}
        if lower.get("x-simon-cluster"):
            return lower["x-simon-cluster"]
        if lower.get("x-simon-tenant"):
            return lower["x-simon-tenant"]
        if body:
            try:
                doc = json.loads(body.decode("utf-8"))
                if isinstance(doc, dict) and doc.get("tenant"):
                    return str(doc["tenant"])
            except ValueError:
                # unparseable body: not an error — route by default key
                log.debug("routing body is not JSON; using default tenant")
        return "default"

    def route_and_forward(
        self,
        method: str,
        path: str,
        body: bytes,
        headers: Dict[str, str],
        rid: str,
    ):
        """Try every live slot in ring order for this key; a dead or
        unreachable replica is marked down and the NEXT slot gets the
        same body with the same request id. Returns
        ``(status, body, header_tuples)``. Exhaustion sheds 503 +
        Retry-After — the caller always gets an answer.

        The whole attempt sequence is one ``fleet/request`` span tree
        under the request's id: each live forward is a
        ``fleet/forward`` child (its span id crosses the wire in
        ``X-Simon-Trace-Context`` so the replica's ``serve/request``
        subtree stitches under it — fleet/trace.py), each failed
        attempt a ``fleet/reroute`` sibling, an exhaustion shed a
        ``fleet/shed`` leaf."""
        COUNTERS.inc("fleet_requests_total")
        key = self.routing_key(headers, body)
        order = self.ring.route_order(key)
        rid_header = (telemetry.REQUEST_ID_HEADER, rid)
        # a chained router hop arrives with its own trace context:
        # remember it as the root's remote parent and keep counting hops
        in_parent, in_hop = telemetry.parse_trace_context(
            headers.get(telemetry.TRACE_CONTEXT_HEADER)
        )
        root_attrs = {"method": method, "key": key}
        if in_parent is not None:
            root_attrs["remote_parent"] = in_parent
            root_attrs["fleet_hop"] = in_hop
        attempted = 0
        with telemetry.request_scope(rid), RECORDER.span(
            "fleet/request", **root_attrs
        ) as root:
            for slot in order:
                replica = self.replicas.get(slot)
                if replica is None or not replica.url:
                    continue
                if self._health.get(slot) == "down":
                    continue
                if slot != order[0] or attempted:
                    # not the key's owner (owner down/skipped) or a retry
                    # after a failed forward — either way a reroute
                    COUNTERS.inc("fleet_reroutes_total")
                attempted += 1
                t_attempt = time.perf_counter()
                try:
                    _inject.fire("fleet.route", slot=slot, key=key)
                    return self._forward(
                        replica, method, path, body, headers, rid,
                        hop=in_hop + 1, attempt=attempted,
                    )
                except (OSError, urllib.error.URLError, GuardError) as e:
                    # connection-level failure (or a classified fault fired
                    # at the fleet.route seam): the replica never produced
                    # an HTTP answer, so retrying elsewhere cannot double-
                    # apply anything. Mark it down; the probe loop will
                    # confirm death and respawn into the slot.
                    log.warning(
                        "replica %s unreachable (%s); rerouting %s",
                        slot, e, rid,
                    )
                    RECORDER.record_span(
                        "fleet/reroute",
                        t_attempt,
                        time.perf_counter(),
                        parent_id=root,
                        slot=slot,
                        attempt=attempted,
                        error=type(e).__name__,
                    )
                    self._mark(slot, "down")
                    COUNTERS.inc("fleet_forward_failures_total")
                    continue
            COUNTERS.inc("fleet_shed_total")
            t_shed = time.perf_counter()
            RECORDER.record_span(
                "fleet/shed", t_shed, t_shed,
                parent_id=root, attempts=attempted,
            )
            return (
                503,
                _shed_body(
                    "fleet",
                    "no live replica could answer (fleet saturated or "
                    "restarting); retry after the hinted delay",
                    rid,
                ),
                (rid_header, ("Retry-After", str(self.retry_after_s()))),
            )

    def _forward(
        self, replica, method, path, body, headers, rid, hop=1, attempt=1
    ):
        """One proxied hop. HTTP error statuses are ANSWERS (a 429's
        Retry-After must reach the client untouched), so urllib's
        HTTPError is converted, never retried. The forward span's id
        crosses the wire as trace context; the reply always carries
        the request id back even when the replica's answer (a proxied
        GET, an old replica) didn't echo it."""
        fwd = {
            k: v
            for k, v in headers.items()
            if k.lower() not in _HOP_HEADERS
        }
        fwd[telemetry.REQUEST_ID_HEADER] = rid
        t0 = time.perf_counter()
        with RECORDER.span(
            "fleet/forward", slot=replica.slot, attempt=attempt
        ) as fwd_sid:
            if fwd_sid is not None:
                fwd[telemetry.TRACE_CONTEXT_HEADER] = (
                    telemetry.format_trace_context(fwd_sid, hop=hop)
                )
            else:
                fwd.pop(telemetry.TRACE_CONTEXT_HEADER, None)
            req = urllib.request.Request(
                replica.url + path,
                data=body if method == "POST" else None,
                headers=fwd,
                method=method,
            )
            try:
                resp = urllib.request.urlopen(
                    req, timeout=self.forward_timeout_s
                )
            except urllib.error.HTTPError as e:
                resp = e  # an answered error status, not a transport fault
            with resp:
                out_body = resp.read()
                out_headers = [
                    (k, v)
                    for k, v in resp.headers.items()
                    if k.lower() not in _HOP_HEADERS
                    and k.lower() != "content-type"
                ]
            out_headers.append(("X-Simon-Fleet-Replica", replica.slot))
            if not any(
                k.lower() == telemetry.REQUEST_ID_HEADER.lower()
                for k, _ in out_headers
            ):
                out_headers.append((telemetry.REQUEST_ID_HEADER, rid))
            COUNTERS.inc(f"fleet_replica_requests:{replica.slot}")
            HISTOS.observe(
                f"fleet/forward/{replica.slot}", time.perf_counter() - t0
            )
            self._update_imbalance_gauge()
            self._note_answer(replica.slot, resp.status)
            return resp.status, out_body, tuple(out_headers)

    def _update_imbalance_gauge(self) -> None:
        """``fleet_slot_imbalance`` gauge: max over slots of
        (slot's cumulative answered requests / fleet mean) − 1 — 0.0
        is a perfectly balanced ring, 1.0 means the hottest slot
        carries double the mean. Sampled into the series store each
        telemetry cadence, judged by the ``fleet_imbalance`` SLO
        kind."""
        counts = [
            COUNTERS.get(f"fleet_replica_requests:{slot}")
            for slot in self.replicas
        ]
        total = sum(counts)
        if total <= 0 or not counts:
            return
        mean = total / len(counts)
        COUNTERS.gauge("fleet_slot_imbalance", max(counts) / mean - 1.0)

    def _note_answer(self, slot: str, status: int) -> None:
        """Audit hook: the first 2xx answered through a slot with a
        pending failover closes that slot's audit timeline."""
        audit = getattr(self, "audit", None)
        if audit is not None and 200 <= int(status) < 300:
            audit.note_first_200(slot)

    # -- health / supervision ------------------------------------------------

    def _mark(self, slot: str, state: str):
        with self._health_lock:
            prev = self._health.get(slot)
            self._health[slot] = state
        if state == "down" and prev != "down":
            COUNTERS.inc("fleet_replica_down_total")
            self._next_probe[slot] = 0.0  # probe loop reacts now

    def retry_after_s(self) -> int:
        """The shed/degraded backoff hint: the largest hint any
        replica advertised, floored at the probe interval (a respawn
        cannot complete faster than the loop that notices the death)."""
        hints = [
            getattr(r, "retry_after_s", 0) or 0 for r in self.replicas.values()
        ]
        return max(1, int(round(self.probe_interval_s)), *hints)

    def readiness(self):
        """-> (status, reasons, per-replica table). Degraded while any
        slot is down/degraded or fleet SLOs alert; the table is what
        CI and ``simon top`` read to find each replica's url/pid."""
        reasons = []
        table = []
        for slot in sorted(self.replicas):
            r = self.replicas[slot]
            state = self._health.get(slot, "down")
            table.append(
                {
                    "id": slot,
                    "url": r.url,
                    "status": state,
                    "pid": getattr(r, "pid", None),
                    "restarts": getattr(r, "restarts", 0),
                    "probeFailures": getattr(r, "probe_failures", 0),
                }
            )
            if state != "up":
                reasons.append(f"replica {slot} is {state}")
        if self.slo_engine is not None:
            reasons.extend(self.slo_engine.reasons())
        return ("degraded" if reasons else "ok"), reasons, table

    def probe_once(self, now: Optional[float] = None) -> None:
        """One supervision pass: probe due replicas, honor degraded
        Retry-After hints, respawn dead process-backed replicas with
        backoff. Called by the probe loop; callable directly in tests
        (deterministic, no sleeps of its own)."""
        now = time.monotonic() if now is None else now
        for slot in sorted(self.replicas):
            replica = self.replicas[slot]
            if now < self._next_probe.get(slot, 0.0):
                continue
            dead = hasattr(replica, "alive") and not replica.alive()
            dead_reason = "process exited" if dead else ""
            if not dead:
                try:
                    _inject.fire("fleet.probe", slot=slot)
                    doc = replica.probe()
                except GuardError as e:  # the fleet.probe seam's faults
                    doc = {"probeOk": False, "error": str(e)}
                    replica.probe_failures += 1
                    COUNTERS.inc("fleet_probe_failures_total")
                if doc.get("probeOk"):
                    state = "degraded" if doc.get("degraded") else "up"
                    self._mark(slot, state)
                    if self.audit is not None:
                        self.audit.note_probe_ok(slot)
                    hint = getattr(replica, "retry_after_s", 0)
                    wait = max(self.probe_interval_s, float(hint or 0))
                    self._next_probe[slot] = now + wait
                    continue
                if self.audit is not None:
                    self.audit.note_probe_flap(
                        slot, failures=replica.probe_failures
                    )
                dead = (
                    replica.probe_failures >= PROBE_FAILURE_THRESHOLD
                    or (hasattr(replica, "alive") and not replica.alive())
                )
                dead_reason = (
                    f"{replica.probe_failures} consecutive probe failures"
                )
                if not dead:
                    # flaky probe: keep routing to it, probe again soon
                    self._next_probe[slot] = now + self.probe_interval_s
                    continue
            self._mark(slot, "down")
            if self.audit is not None:
                self.audit.note_declared_dead(slot, reason=dead_reason)
            if not (self.supervise and hasattr(replica, "spawn")):
                self._next_probe[slot] = now + self.probe_interval_s
                continue
            self._failover(replica)
            self._next_probe[slot] = time.monotonic() + self.probe_interval_s

    def _failover(self, replica) -> None:
        """Respawn a dead replica into its slot. The slot keeps its
        ring position (zero key movement) and its snapshot journal
        (the replacement replays the dead replica's delta stream)."""
        slot = replica.slot
        COUNTERS.inc("fleet_failovers_total")
        log.warning("replica %s is down; respawning into its slot", slot)
        replica.kill()  # reap a half-dead process before reclaiming
        replica.release()
        if self.audit is not None:
            self.audit.note_lock_reclaim(slot)
        replica.restarts += 1
        replica.probe_failures = 0
        try:
            replica.spawn(attempts=self.spawn_attempts)
        except Exception as e:  # noqa: BLE001 - the loop retries next pass
            log.error("respawn of %s failed: %s", slot, e)
            COUNTERS.inc("fleet_respawn_failures_total")
            if self.audit is not None:
                self.audit.note_respawn(slot, ok=False, error=str(e))
            return
        self._mark(slot, "up")
        COUNTERS.inc("fleet_respawns_total")
        if self.audit is not None:
            self.audit.note_respawn(
                slot, ok=True, pid=getattr(replica, "pid", None)
            )
            self.audit.note_replay_progress(
                slot, delta_seq=self._fetch_delta_seq(replica)
            )

    def _fetch_delta_seq(self, replica) -> Optional[int]:
        """The replacement's replayed delta sequence from its
        state-digest endpoint — audit evidence that journal replay
        finished, best-effort (None when unreachable)."""
        if not replica.url:
            return None
        try:
            with urllib.request.urlopen(
                replica.url + "/v1/state-digest", timeout=5.0
            ) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
            return int(doc.get("deltaSeq"))
        except (OSError, urllib.error.URLError, ValueError, TypeError):
            return None

    def _probe_loop(self):
        while not self._shutdown.is_set():
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 - supervision must not die
                log.exception("fleet probe pass failed")
            self._shutdown.wait(min(0.2, self.probe_interval_s))

    # -- metrics scrape ------------------------------------------------------

    def scrape_replica(self, replica) -> str:
        """A replica's /metrics text, cached for SCRAPE_TTL_S."""
        now = time.monotonic()
        cached = self._scrape_cache.get(replica.slot)
        if cached is not None and now - cached[0] < SCRAPE_TTL_S:
            return cached[1]
        if not replica.url or self._health.get(replica.slot) == "down":
            return ""
        try:
            with urllib.request.urlopen(
                replica.url + "/metrics", timeout=self.forward_timeout_s
            ) as resp:
                text = resp.read().decode("utf-8", "replace")
        except (OSError, urllib.error.URLError):
            return ""
        self._scrape_cache[replica.slot] = (now, text)
        return text

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self.telemetry.start()
        self._server_thread.start()
        if self.probe_interval_s > 0:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="simon-fleet-probe", daemon=True
            )
            self._probe_thread.start()
        log.info("simon fleet listening on %s:%d", self.host, self.port)

    def begin_shutdown(self):
        self._shutdown.set()

    def shutdown(self) -> int:
        """Drain the fleet: stop probing (no respawns during drain),
        SIGTERM every process-backed replica, wait for their drains,
        release slot locks. Exit 0 when every replica drained in time,
        3 when one had to be killed."""
        self.begin_shutdown()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
        clean = True
        deadline = time.monotonic() + self.drain_timeout_s
        for r in self.replicas.values():
            if hasattr(r, "terminate"):
                r.terminate()
        for r in self.replicas.values():
            if not hasattr(r, "wait"):
                continue
            rc = r.wait(max(0.1, deadline - time.monotonic()))
            if rc is None:
                log.warning(
                    "replica %s did not drain in time; killing", r.slot
                )
                r.kill()
                clean = False
            elif rc != 0:
                log.warning("replica %s drained with rc=%d", r.slot, rc)
                clean = False
            if hasattr(r, "release"):
                r.release()
        self.telemetry.stop()
        if self.audit is not None:
            self.audit.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        return EXIT_OK if clean else EXIT_PARTIAL_DEADLINE

    def run_until_signaled(self) -> int:
        def handler(signum, frame):
            log.info("received signal %d: draining fleet", signum)
            self._wake.set()

        self._wake = threading.Event()
        prev_term = signal.signal(signal.SIGTERM, handler)
        prev_int = signal.signal(signal.SIGINT, handler)
        try:
            self._wake.wait()
            return self.shutdown()
        finally:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)


# -- exposition --------------------------------------------------------------


def render_fleet_metrics(router: FleetRouter) -> bytes:
    """Prometheus exposition of the router's own counters plus the
    cardinality-bounded per-replica re-export (one sample per
    allowlisted family per live replica, labeled ``{replica="rN"}``)."""
    from ..serve.server import _escape_label

    snap = COUNTERS.snapshot()
    counts = snap["counts"]
    lines: List[str] = []

    def metric(name, kind, help_text, value):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")

    metric(
        "simon_fleet_requests_total", "counter",
        "Requests accepted by the fleet router (any outcome).",
        counts.get("fleet_requests_total", 0),
    )
    metric(
        "simon_fleet_reroutes_total", "counter",
        "Requests retried against another replica after a forward failure.",
        counts.get("fleet_reroutes_total", 0),
    )
    metric(
        "simon_fleet_shed_total", "counter",
        "Requests shed 503 because no live replica could answer.",
        counts.get("fleet_shed_total", 0),
    )
    metric(
        "simon_fleet_forward_failures_total", "counter",
        "Connection-level forward failures (replica marked down).",
        counts.get("fleet_forward_failures_total", 0),
    )
    metric(
        "simon_fleet_failovers_total", "counter",
        "Replica deaths detected by the supervision loop.",
        counts.get("fleet_failovers_total", 0),
    )
    metric(
        "simon_fleet_respawns_total", "counter",
        "Replacement replicas successfully spawned into a slot.",
        counts.get("fleet_respawns_total", 0),
    )
    metric(
        "simon_fleet_respawn_failures_total", "counter",
        "Failover respawns that exhausted their spawn attempts.",
        counts.get("fleet_respawn_failures_total", 0),
    )
    metric(
        "simon_fleet_spawn_total", "counter",
        "Replica child processes launched (initial + respawns).",
        counts.get("fleet_spawn_total", 0),
    )
    metric(
        "simon_fleet_spawn_retry_total", "counter",
        "Spawn attempts that failed and were retried with backoff.",
        counts.get("fleet_spawn_retry_total", 0),
    )
    metric(
        "simon_fleet_probe_failures_total", "counter",
        "Health probes that failed (connection error or injected fault).",
        counts.get("fleet_probe_failures_total", 0),
    )
    metric(
        "simon_fleet_replayed_deltas_total", "counter",
        "Cluster deltas replayed into bootstrapping sessions.",
        counts.get("fleet_replayed_deltas_total", 0),
    )
    metric(
        "simon_fleet_replay_torn_tail_total", "counter",
        "Torn journal tails dropped during bootstrap replay.",
        counts.get("fleet_replay_torn_tail_total", 0),
    )
    up = sum(1 for s in router.replicas if router._health.get(s) == "up")
    metric(
        "simon_fleet_replicas", "gauge",
        "Configured replica slots.", len(router.replicas),
    )
    metric(
        "simon_fleet_replicas_up", "gauge",
        "Replica slots currently routable.", up,
    )

    # -- per-replica series (bounded: a few fixed families x N slots)
    lines.append(
        "# HELP simon_fleet_replica_up Replica routability (1 up, 0 not)."
    )
    lines.append("# TYPE simon_fleet_replica_up gauge")
    for slot in sorted(router.replicas):
        v = 1 if router._health.get(slot) == "up" else 0
        lines.append(
            f'simon_fleet_replica_up{{replica="{_escape_label(slot)}"}} {v}'
        )
    lines.append(
        "# HELP simon_fleet_replica_requests_total Requests answered per "
        "replica (router-side count)."
    )
    lines.append("# TYPE simon_fleet_replica_requests_total counter")
    for slot in sorted(router.replicas):
        n = counts.get(f"fleet_replica_requests:{slot}", 0)
        lines.append(
            "simon_fleet_replica_requests_total"
            f'{{replica="{_escape_label(slot)}"}} {n}'
        )

    scraped: Dict[str, List[str]] = {name: [] for name in REPLICA_METRIC_ALLOWLIST}
    for slot in sorted(router.replicas):
        text = router.scrape_replica(router.replicas[slot])
        if not text:
            continue
        for line in text.splitlines():
            if line.startswith("#") or not line.strip():
                continue
            name, _, value = line.partition(" ")
            if name in scraped:
                scraped[name].append(
                    f'simon_fleet_{name[len("simon_"):]}'
                    f'{{replica="{_escape_label(slot)}"}} {value}'
                )
    for name in REPLICA_METRIC_ALLOWLIST:
        if not scraped[name]:
            continue
        short = name[len("simon_"):]
        lines.append(
            f"# HELP simon_fleet_{short} Per-replica re-export of {name}."
        )
        lines.append(f"# TYPE simon_fleet_{short} untyped")
        lines.extend(scraped[name])
    # staleness of the TTL-cached aggregation itself: age of the OLDEST
    # cached replica scrape (0 with an empty cache). Also pushed as a
    # gauge so the series store / SLO engine can watch it.
    now = time.monotonic()
    ages = [now - t for (t, _) in router._scrape_cache.values()]
    cache_age = round(max(ages), 3) if ages else 0.0
    COUNTERS.gauge("fleet_metrics_cache_age_seconds", cache_age)
    metric(
        "simon_fleet_metrics_cache_age_seconds", "gauge",
        "Age of the oldest cached replica /metrics scrape (TTL "
        f"{SCRAPE_TTL_S}s).",
        cache_age,
    )
    metric(
        "simon_fleet_slot_imbalance", "gauge",
        "Hottest slot's answered-request share over the fleet mean, "
        "minus one (0 = balanced).",
        round(snap["gauges"].get("fleet_slot_imbalance", 0.0), 6),
    )
    metric(
        "simon_fleet_failovers_audited_total", "counter",
        "Failover episodes closed by the audit timeline.",
        counts.get("fleet_failovers_audited_total", 0),
    )
    metric(
        "simon_fleet_failover_ms_total", "counter",
        "Cumulative audited failover duration (integer milliseconds).",
        counts.get("fleet_failover_ms_total", 0),
    )
    metric(
        "simon_fleet_failover_seconds", "gauge",
        "Total duration of the most recently audited failover episode.",
        round(snap["gauges"].get("fleet_failover_seconds", 0.0), 6),
    )
    # per-phase breakdown of the last audited episode (bounded: the
    # fixed 5-phase partition, absent until a failover has been audited)
    from .audit import PHASE_DURATIONS

    phase_lines = []
    for phase in PHASE_DURATIONS:
        v = snap["gauges"].get(f"fleet_failover_phase_seconds:{phase}")
        if v is not None:
            phase_lines.append(
                "simon_fleet_failover_phase_seconds"
                f'{{phase="{_escape_label(phase)}"}} {round(v, 6)}'
            )
    if phase_lines:
        lines.append(
            "# HELP simon_fleet_failover_phase_seconds Last audited "
            "episode's per-phase durations (they partition the total)."
        )
        lines.append("# TYPE simon_fleet_failover_phase_seconds gauge")
        lines.extend(phase_lines)
    if router.slo_engine is not None:
        lines.extend(router.slo_engine.prometheus_lines())
    return ("\n".join(lines) + "\n").encode()
